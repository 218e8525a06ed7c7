"""The benchmark of ``hiddenpose_tpu_torch`` on NVIDIA H100s.

``python3 -m hpbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``,
``harness.py``).  The yardstick lives here, apart from the program:
the inputs made from the seed (``inputs.py``), the plain reference and
its train step (``reference/``), the roofline and FLOP arithmetic
(``roofline.py``), the traffic generators (``generators/``) and their
mixes (``traffic/``), the configurations (``configs/``) and one reader
per per-layer metric (``layer_metrics/``).
"""
