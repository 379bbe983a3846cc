"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
H100: the port's prefill and decode serving the whole Mistral-NeMo-12B.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``BENCHMARK.json``'s ``workloads``) in one
process and prints one JSON line. What belongs to one configuration, one
traffic mix or one metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``mixes/<traffic>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``, and by the
configuration's family ``reference/<family>.py`` (the plain fp32
reference) and ``counts/<family>.py`` (operations and bytes).
"""
