"""Models: linear models over b-bit codes and over VW sketches
(``linear``), and the LM zoo's ten architectures (``layers``,
``transformer``, ``moe``, ``ssm``, ``xlstm``, ``hybrid``, ``encdec``,
behind one contract in ``api``)."""
