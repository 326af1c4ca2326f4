"""The benchmark of ``savgol_tpu_torch`` on one NVIDIA H100.

One run is one process::

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own, found by name (``layout.py``):
``configs/<config>.json`` and ``entries/<config>.py`` (the program's entry
point), ``references/<function>.py`` (the plain reference and the inputs),
``workloads/<cell>.json`` (the traffic) and ``layer_metrics/<metric>.py``
(a reader of the traced window). The yardstick (``roofline.py``,
``trace.py``, the references) lives here, so the program under test cannot
move it. Nothing here imports JAX or the JAX package ``savgol_tpu``.
"""
