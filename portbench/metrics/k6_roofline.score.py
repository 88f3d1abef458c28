"""K6's share of its roofline in the scoring window (%): the least time of
every launch the window's shards made (one a Mamba2 layer, at the shard's
rows; ``counts.ssd_scan_terms``), over the device time of K6's forward
kernels in the trace.  Nothing when the trace holds no K6 kernel."""

from portbench import counts


def read(run):
    if run.trace is None:
        return None
    m, s = run.model, counts.ssm_shape(run.model)
    seq = run.traffic["tokens_per_record"]
    bound = sum(m["n_layers"] * counts.ssd_scan_terms(
        rows, seq, s["H"], s["P"], s["N"], s["chunk"], m["act_dtype"]).seconds
        for rows in run.counters.get("lm_shards", ()))
    lo, hi = run.window
    device = sum(min(e, hi) - max(a, lo)
                 for a, e in run.trace.matching("ssd_scan", exclude="bwd")
                 if min(e, hi) > max(a, lo))
    return 100.0 * bound / device if device > 0 and bound > 0 else None
