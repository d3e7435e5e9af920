"""The benchmark harness of the PyTorch/CUDA port (``repro_torch``).

Everything that belongs to one configuration, one traffic mix, one cell,
one loop, one driver, one end-to-end metric or one per-layer metric sits
in a file of its own under ``bench/``, found by the name that
``BENCHMARK.json`` or a cell's files give it (:mod:`benchkit.manifest`).
This package holds what they share: the loops' records and the closed
loop (:mod:`benchkit.loop`), the check of a traffic mix
(:mod:`benchkit.traffic`), the end-to-end statistics
(:mod:`benchkit.stats`), the profiler windows and their
reduction to device time by layer (:mod:`benchkit.trace`), the table of
peaks (:mod:`benchkit.peaks`), the lower-precision roundings the controls
use (:mod:`benchkit.rounding`) and the run itself (:mod:`benchkit.runner`).
Nothing here imports JAX or the JAX package ``repro``.
"""
