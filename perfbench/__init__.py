"""The benchmark of ``aread_tpu_torch`` on one NVIDIA H100: the harness
(``run.py``), what the cells' drivers share (``driving.py``), the inputs
made from the seed (``inputs.py``), the profiler's reduction
(``trace.py``), the chip's peaks and the work's counts (``roofline.py``),
the shared parts of the plain reference (``reference/``), the comparison
that decides ``correct`` (``check.py``) and the readings its limits were
set from (``calibrate.py``). The files of a cell are found by the names
in ``BENCHMARK.json`` and in the files it names (``registry.py``):
``configs/``, ``traffic/``, ``limits/``, ``drivers/``, a model's
``reference/<model>.py`` and ``layer_metrics/``."""
