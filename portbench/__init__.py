"""The benchmark of the PyTorch / CUDA port (``repro_torch``) on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, one model family, one
traffic mix, one kind of traffic or one per-layer metric is a file of its
own, found by the name that ``BENCHMARK.json`` or the file before it gives
it:

* ``configs/<config>.json``: the model's sizes as run, its source, what was
  cut and what was assumed, and the small sizes of the CPU tests;
* ``families/<family>.py`` (the configuration's ``model.family``): the
  family's weight tree, its layers in the plain reference and its frozen
  count of model FLOPs;
* ``traffic/<mix>.json``: the parameters of one traffic mix;
* ``drivers/<kind>.py`` (the mix's ``kind``): the general driver that reads
  such mixes, runs the window and judges it;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(run) -> float | None``; a metric without a file of its own takes
  the reader of its stem, the name before its first dot;
* ``limits/<cell>.json``: the limits that decide ``correct`` in one cell,
  each with the readings it was set from.

The rest is the yardstick, which later changes to the program cannot
move: the plain float32 reference (:mod:`portbench.reference`), the frozen
byte and operation counts of the kernels and the card's peaks
(:mod:`portbench.counts`), the seeded weights (:mod:`portbench.weights`),
the reduction of the profiler's trace (:mod:`portbench.devtrace`), the window statistics
(:mod:`portbench.stats`) and the comparison that decides ``correct``
(:mod:`portbench.check`).  The harness imports nothing of the JAX package
and refuses to print a result when ``jax``, ``jaxlib``, ``flax`` or
``repro`` was loaded (:mod:`portbench.guard`).
"""
