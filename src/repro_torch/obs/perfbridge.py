"""The perf bridge: counted FLOPs, bytes, collective traffic and roofline
fractions of any torch callable — the port's counterpart of
``repro.obs.perfbridge``.

:func:`perf_record` runs the callable once under
:class:`repro_torch.perf.counts.OpCounter` (the port's kernels report their
launches' work; aten ops are counted as they run) and returns the record a
benchmark row embeds:

    {"counted_flops": ..., "counted_bytes": ..., "wire_bytes": ...,
     "collective_counts": {...}, "kernels": {...}, "roofline": {...},
     "roofline_fraction": ..., "measured_s": ..., "n_recompiles": ...,
     "compile_s": ...}

Keys that name HLO in the reference are renamed: ``hlo_flops`` →
``counted_flops`` and ``hlo_bytes`` → ``counted_bytes`` (an eager count of
one call, not a parsed module); ``kernels`` is new (the per-kernel split of
the count).  ``roofline`` is :meth:`RooflineTerms.row`, key for key the
reference's, on the H100's rates (``repro_torch.perf.roofline.step_terms``:
the dense bf16 tensor-core peak, HBM3, NVLink).

``roofline_fraction`` is roofline-bound time over measured time: the
fraction of the card's roofline the measured call achieves (1.0 = running
at the max(compute, memory, collective) bound).  ``n_recompiles`` and
``compile_s`` come from :mod:`repro_torch.obs.kernelhooks`: the kernel
libraries built or opened in the region of the ``compile_snapshot`` the
caller took before it (:func:`repro_torch.obs.bench.measure`'s convention),
or else in the counted call itself.
"""

from __future__ import annotations

from repro_torch.obs import kernelhooks

__all__ = ["perf_record", "attach_to_span"]


def perf_record(fn, args: tuple = (), kwargs: dict | None = None,
                measured_s: float | None = None,
                model_flops: float | None = None, chips: int = 1,
                compile_snapshot: kernelhooks.CompileSnapshot | None = None
                ) -> dict:
    """Count one call of ``fn(*args, **kwargs)`` and build its record.

    ``measured_s`` (seconds per call of the same operands, measured by the
    caller) turns the roofline bound into ``roofline_fraction``;
    ``model_flops`` defaults to the counted FLOPs (useful fraction 1.0)
    when the caller has no analytic model.  ``compile_snapshot`` — taken
    BEFORE the measured region — contributes ``n_recompiles`` /
    ``compile_s`` for that region; without one they report the builds the
    counted call itself performed.
    """
    from repro_torch.perf.counts import analyze_call
    from repro_torch.perf.roofline import step_terms

    own = kernelhooks.snapshot()
    stats = analyze_call(fn, args, kwargs)
    wire = stats.collectives.total_wire_bytes
    terms = step_terms(
        stats.flops, stats.hbm_bytes, wire, chips,
        stats.flops if model_flops is None else model_flops)
    snap = compile_snapshot if compile_snapshot is not None else own
    n_recompiles, compile_s = snap.delta()
    return {
        "counted_flops": float(stats.flops),
        "counted_bytes": float(stats.hbm_bytes),
        "wire_bytes": float(wire),
        "collective_counts": {k: int(v)
                              for k, v in stats.collectives.counts.items()},
        "kernels": stats.kernels,
        "roofline": terms.row(),
        "roofline_fraction": (
            None if not measured_s or measured_s <= 0
            else terms.step_time_s / measured_s),
        "measured_s": measured_s,
        "n_recompiles": int(n_recompiles),
        "compile_s": float(compile_s),
    }


def attach_to_span(sp, fn, args: tuple = (), kwargs: dict | None = None,
                   **rec_kwargs) -> dict:
    """Compute :func:`perf_record` and fold it into a live span's args (the
    trace event then carries the FLOPs/roofline block) under ``"perf"``.
    Works on the disabled-path null span too (record still returned,
    nothing stored)."""
    from repro_torch.obs.spans import Span

    rec = perf_record(fn, args, kwargs, **rec_kwargs)
    if isinstance(sp, Span):
        sp.args["perf"] = rec
    return rec
