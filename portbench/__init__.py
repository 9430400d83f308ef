"""The benchmark of the PyTorch and CUDA port (``fastconsensus_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
driver or metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``drivers/<driver>.py``,
``metrics/<metric>.py`` and ``limits/<config>.json``.
"""
