"""The streaming engine's host share of ``run_batch`` (%): each batch's
wall less its scoring operator's shard calls, over the batches' wall, on
the host clock, over the window's batches."""


def read(run):
    lo, hi = run.window
    batches = run.spans.within("engine.run_batch", lo, hi)
    model = next(s["name"] for s in run.traffic["dag"] if s["op"] == "model")
    calls = run.spans.within("op." + model, lo, hi)
    wall = sum(b - a for a, b in batches)
    if not wall:
        return None
    return 100.0 * (wall - sum(b - a for a, b in calls)) / wall
