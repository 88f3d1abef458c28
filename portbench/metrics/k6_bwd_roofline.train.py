"""K6's backward's share of its roofline in the training window (%): the
least time of one launch a Mamba2 layer a step at the step's shape
(``counts.ssd_scan_bwd_terms``), over the device time of K6's backward
kernels in the trace.  Nothing when the trace holds none."""

from portbench import counts


def read(run):
    if run.trace is None:
        return None
    m, s, tr = run.model, counts.ssm_shape(run.model), run.traffic
    bound = run.counters.get("steps", 0) * m["n_layers"] \
        * counts.ssd_scan_bwd_terms(tr["batch"], tr["seq_len"], s["H"],
                                    s["P"], s["N"], s["chunk"],
                                    m["act_dtype"]).seconds
    lo, hi = run.window
    device = sum(min(e, hi) - max(a, lo)
                 for a, e in run.trace.matching("ssd_bwd")
                 if min(e, hi) > max(a, lo))
    return 100.0 * bound / device if device > 0 and bound > 0 else None
