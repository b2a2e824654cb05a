"""Run configurations of the port: the paper's b-bit deployment
(``rcv1_bbit``) and the OPH serving and streaming one (``rcv1_oph``).
The reference's exports here (``ArchConfig``, ``register``,
``get_config``, ``list_configs``) are its LM zoo's (ROADMAP A6)."""

__all__: list = []
