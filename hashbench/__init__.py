"""hashbench: the benchmark of the PyTorch + CUDA port (``repro_torch``).

One command runs one cell once (``python3 hashbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``); see README.md.  The
harness is driven by data: a cell of BENCHMARK.json names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``), whose ``loop`` names the loop that drives the
program (``loops/<loop>.py``); each per-layer metric is a reader of
its own (``metrics/<metric>.py``), and each cell's comparison with the
plain reference has its limits in ``checks/<workload>.json``.
"""
