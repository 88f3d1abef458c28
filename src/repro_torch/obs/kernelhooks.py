"""Kernel build and launch accounting — the port's counterpart of
``repro.obs.jaxhooks``.

The port has no jit: its counterpart of a compile is a CUDA kernel library
built with ``nvcc`` or opened by ``repro_torch.kernels.build.load``, which
call every function in ``build.listeners`` with ``(builds, loads,
seconds)``.  One listener (installed lazily, at most once; it stays
registered and checks an armed flag, as the reference's) turns those calls
into:

  * module-level totals (``compile_count``: libraries built plus libraries
    opened; ``compile_seconds``: the wall time of the calls that did so,
    builds included), updated while armed — ``repro_torch.obs.bench``
    snapshots them around timed regions to report ``n_recompiles``;
  * the default registry's ``kernels.builds`` counter (the same count) and
    ``kernels.build_seconds`` total, when the registry is enabled;
  * build-time attribution on the innermost active span
    (:mod:`repro_torch.obs.spans`), which is how a span splits its wall
    time into ``compile_s`` and ``execute_s``.

Launches are counted by the kernel wrappers themselves (a ``launches`` dict
in each of ``repro_torch.kernels.{edge_latency, flash_attention, ssd_scan,
rmsnorm}``).  :func:`launch_counts` reads them and :func:`publish_launches`
adds what they counted since its last call to the registry's
``kernels.launches`` counters, labelled by kernel; :func:`snapshot` and
:meth:`CompileSnapshot.delta` publish, so the counters are current at both
ends of every region ``repro_torch.obs.bench.measure`` or
``repro_torch.obs.perfbridge.perf_record`` measures.
"""

from __future__ import annotations

import threading

from repro_torch.kernels import build

__all__ = ["install", "installed", "disarm", "snapshot", "CompileSnapshot",
           "compile_count", "compile_seconds", "launch_counts",
           "publish_launches"]

_lock = threading.Lock()
_installed = False
_armed = False
_published: dict[str, int] = {}

compile_count = 0
compile_seconds = 0.0


def _on_build(builds: int, loads: int, seconds: float) -> None:
    global compile_count, compile_seconds
    if not _armed:
        return
    n = builds + loads
    compile_count += n
    compile_seconds += seconds
    from repro_torch.obs import spans
    from repro_torch.obs.registry import registry

    spans._attribute_compile(seconds, n)
    reg = registry()
    if reg.enabled:
        reg.counter("kernels.build_seconds").add(seconds)
        reg.counter("kernels.builds").add(n)


def install() -> None:
    """Arm build accounting (idempotent).  The listener is registered once
    per process and never removed; disarming clears the flag only."""
    global _installed, _armed
    with _lock:
        if not _installed:
            build.listeners.append(_on_build)
            _installed = True
        _armed = True


def installed() -> bool:
    return _installed and _armed


def disarm() -> None:
    """Stop accounting (the listener stays registered and returns at
    once)."""
    global _armed
    _armed = False


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels import edge_latency, flash_attention, rmsnorm, \
        ssd_scan
    out: dict[str, int] = {}
    for mod in (edge_latency, flash_attention, ssd_scan, rmsnorm):
        out.update(mod.launches)
    return out


def publish_launches() -> dict[str, int]:
    """Add the launches counted since the last call to the registry's
    ``kernels.launches{kernel=...}`` counters (when it is enabled); returns
    those deltas.  A wrapper's ``reset_launches`` restarts its count: a
    count below the last one published is taken as new launches."""
    from repro_torch.obs.registry import registry

    now = launch_counts()
    delta = {}
    with _lock:
        for name, n in now.items():
            last = _published.get(name, 0)
            delta[name] = n - last if n >= last else n
            _published[name] = n
    reg = registry()
    if reg.enabled:
        for name, d in delta.items():
            if d:
                reg.counter("kernels.launches", kernel=name).add(d)
    return delta


class CompileSnapshot:
    """Point-in-time build totals; subtract two to get a window."""

    def __init__(self):
        self.count = compile_count
        self.seconds = compile_seconds

    def delta(self) -> tuple[int, float]:
        """(libraries built or opened, their seconds) since this snapshot;
        publishes the launches."""
        publish_launches()
        return (compile_count - self.count, compile_seconds - self.seconds)


def snapshot() -> CompileSnapshot:
    """Arm the hooks, publish the launches and snapshot the totals (see
    CompileSnapshot)."""
    install()
    publish_launches()
    return CompileSnapshot()
