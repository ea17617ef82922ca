"""cardbench: the benchmark of libflagstats_tpu_torch on one or more CUDA cards.

One run measures one cell (a configuration under a traffic mix) of
``BENCHMARK.json`` at the repository root:

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that decides a number lives here and imports nothing of the
program: the data and frame makers, the plain references, the trace
arithmetic and the table of peaks. Configurations (``configs/*.json``),
traffic mixes (``traffic/*.json``), column kinds (``columns/*.py``),
entry points (``entries/*.py``), references (``references/*.py``) and
metric readers (``end_to_end/*.py``, ``layer_metrics/*.py``) are found
by name, so a new cell, kind or metric is new files only.
"""
