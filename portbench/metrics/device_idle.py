"""The card's idle share of the traced window (%): one less the union of
its operations' intervals over the window's length."""

from portbench import stats


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.window
    busy = stats.busy([(a, e) for _, a, e in run.trace.ops], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
