"""Structured spans with wall/compile/execute split and Chrome-trace export.

``span("score_grid", S=4, P=1024)`` is a context manager recording one
timed region into the process-local trace buffer.  Each span carries:

  * ``wall_s``    — perf_counter wall time of the region;
  * ``compile_s`` / ``n_compiles`` — kept for schema parity with
    ``repro.obs.spans``; PyTorch runs eagerly and the port's kernels are
    built once at set-up, so both read 0;
  * ``execute_s`` — ``wall_s − compile_s``.  Call ``sp.sync(value)``
    (``torch.cuda.synchronize`` for a CUDA tensor) before leaving the span
    so asynchronously launched device work is *inside* the wall
    measurement — otherwise a launch-and-return would read as ~0 execute.

Spans nest (``parent`` links reconstruct the tree) and export as
Chrome-trace events — one JSON object per line (JSONL), each a complete
``"ph": "X"`` duration event, plus ``"ph": "C"`` counter samples for the
timelines (:func:`counter_sample`) — so a whole adaptive run opens in
``ui.perfetto.dev`` or ``chrome://tracing``.  :func:`load_trace` /
:func:`validate_events` are the schema the export is tested against.

Everything here is registry-gated: with the default registry disabled,
``span(...)`` returns a shared no-op span and the buffer never grows.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from repro_torch.obs.registry import registry

__all__ = ["Span", "span", "current_span", "counter_sample", "trace_events",
           "clear_trace", "export_trace", "load_trace", "validate_events",
           "TRACE_EVENT_KEYS"]

# required keys of one exported Chrome-trace event line
TRACE_EVENT_KEYS = {"name", "ph", "ts", "pid", "tid"}

_local = threading.local()
_buffer_lock = threading.Lock()
_events: list[dict] = []
# one perf_counter origin per process so ts is comparable across threads
_T0 = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One live timed region; becomes a ``"ph": "X"`` trace event on exit."""

    __slots__ = ("name", "args", "t0_us", "wall_s", "compile_s",
                 "n_compiles", "_synced")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self.t0_us = 0.0
        self.wall_s = 0.0
        self.compile_s = 0.0
        self.n_compiles = 0
        self._synced = False

    @property
    def execute_s(self) -> float:
        return max(self.wall_s - self.compile_s, 0.0)

    def sync(self, value):
        """``torch.cuda.synchronize`` when ``value`` is a CUDA tensor, so
        device work lands inside this span's wall time; returns ``value``.
        A CPU tensor or host value is already complete."""
        import torch

        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
        self._synced = True
        return value

    def __enter__(self):
        self.t0_us = _now_us()
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now_us()
        self.wall_s = (t1 - self.t0_us) / 1e6
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        args = dict(self.args)
        args["compile_s"] = self.compile_s
        args["execute_s"] = self.execute_s
        args["n_compiles"] = self.n_compiles
        args["synced"] = self._synced
        ev = {"name": self.name, "ph": "X", "ts": self.t0_us,
              "dur": t1 - self.t0_us, "pid": os.getpid(),
              "tid": threading.get_ident(), "args": args}
        with _buffer_lock:
            _events.append(ev)
        return False


class _NullSpan:
    """Shared disabled-path span: every operation is a no-op."""

    __slots__ = ()
    name = ""
    args: dict = {}
    wall_s = compile_s = execute_s = 0.0
    n_compiles = 0

    def sync(self, value):
        return value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullSpan()


def span(name: str, **args):
    """Open a span when telemetry is enabled; a shared no-op otherwise.
    ``args`` must be JSON-able (they land in the trace event's ``args``)."""
    if not registry().enabled:
        return _NULL
    return Span(name, args)


def current_span():
    """The innermost active span of this thread (None outside any span, or
    when telemetry is disabled)."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def counter_sample(name: str, value: float, **more) -> None:
    """Append one counter sample (Perfetto renders a counter track per
    name) — the drift/regret timelines of the adaptive loop.  No-op when
    telemetry is disabled."""
    if not registry().enabled:
        return
    series = {name: float(value)}
    for k, v in more.items():
        series[k] = float(v)
    ev = {"name": name, "ph": "C", "ts": _now_us(), "pid": os.getpid(),
          "tid": threading.get_ident(), "args": series}
    with _buffer_lock:
        _events.append(ev)


def trace_events() -> list[dict]:
    """Snapshot of the buffered trace events (copies the list, not the
    events)."""
    with _buffer_lock:
        return list(_events)


def clear_trace() -> None:
    with _buffer_lock:
        _events.clear()


def export_trace(path) -> int:
    """Write the buffer as Chrome-trace JSONL: one complete event object
    per line.  Perfetto and ``chrome://tracing`` both ingest the JSON
    array form; :func:`load_trace` turns the JSONL back into that form.
    Returns the number of events written."""
    events = trace_events()
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return len(events)


def load_trace(path) -> list[dict]:
    """Load + schema-validate an exported JSONL trace (the bench_obs /
    tier-1 gate that the export stays viewer-loadable)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    validate_events(events)
    return events


def validate_events(events: list[dict]) -> None:
    """Raise ValueError unless every event is a well-formed Chrome-trace
    event: required keys, numeric ts (µs), ``X`` events carry a numeric
    ``dur`` and a dict ``args``, ``C`` events a numeric series dict."""
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        missing = TRACE_EVENT_KEYS - ev.keys()
        if missing:
            raise ValueError(f"event {i} missing keys {sorted(missing)}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} ts is not numeric")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i} ('X') needs numeric dur >= 0")
            if not isinstance(ev.get("args", {}), dict):
                raise ValueError(f"event {i} args is not an object")
        elif ev["ph"] == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"event {i} ('C') needs a numeric series")
        else:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")


@contextlib.contextmanager
def _fresh_trace():
    """Test helper: run with an empty buffer, restore afterwards."""
    global _events
    with _buffer_lock:
        saved, _events = _events, []
    try:
        yield
    finally:
        with _buffer_lock:
            _events = saved
