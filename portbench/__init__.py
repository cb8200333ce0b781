"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the configuration's file
(``configs/<name>.json``, its ``driver`` key naming ``drivers/<driver>.py``),
the traffic (``traffic/<name>.json``), the limits of the output comparison
(``limits/<cell>.json``) and each per-layer metric's reader
(``metrics/<name>.py``).  ``reference/`` is the plain reference that decides
``correct``; it imports nothing of the program.
"""
