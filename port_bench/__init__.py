"""The benchmark of the PyTorch and CUDA port (``moss_speech_decoder_cosy_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration under
``configs/``, its cell file under ``workloads/``, its traffic mix under
``traffic/``, its entry driver under ``drivers/``, the plain reference of its
configuration under ``reference/`` and each per-layer metric's reader under
``metrics/``.
"""
