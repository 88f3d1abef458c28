"""repro_torch.obs — the port's copy of ``repro.obs``: spans and metrics
across sim → serve, the benchmark timing harness (:mod:`.bench`), kernel
build and launch accounting (:mod:`.kernelhooks`, the counterpart of the
jax compile hooks: a kernel library built or opened is the port's
compile) and the perf bridge (:mod:`.perfbridge`: counted FLOPs, bytes and
roofline fractions of any torch callable).

Zero-dependency and opt-in-cheap: the default registry is DISABLED until
:func:`enable` — every instrumentation site guards on one attribute read,
and enabling never changes numerics (gated in ``benchmarks/bench_obs.py``).

    from repro_torch import obs

    obs.enable()
    with obs.span("score_grid", S=4, P=1024) as sp:
        sp.sync(ev.score_grid(placements, coms))
    obs.export_trace("run.trace.jsonl")      # open in ui.perfetto.dev
    obs.registry().snapshot()                # metrics rows

See ``src/repro/obs/README.md`` for the telemetry flow diagram.
"""

from repro_torch.obs.bench import Timing, measure, time_once
from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricsRegistry,
                                disable, enable, enabled, registry,
                                set_registry)
from repro_torch.obs.spans import (Span, clear_trace, counter_sample, current_span,
                             export_trace, load_trace, span, trace_events,
                             validate_events)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "registry", "set_registry", "enable", "disable", "enabled",
    "Span", "span", "current_span", "counter_sample",
    "trace_events", "clear_trace", "export_trace", "load_trace",
    "validate_events", "Timing", "measure", "time_once",
]
