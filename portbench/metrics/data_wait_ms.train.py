"""The time a training step waits for its batch (ms): the host clock around
``Prefetcher.next()``, the mean over the window's steps."""


def read(run):
    lo, hi = run.window
    waits = run.spans.within("data.next", lo, hi)
    if not waits:
        return None
    return 1e3 * sum(b - a for a, b in waits) / len(waits)
