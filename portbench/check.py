"""The comparison that decides ``correct``: the numbers a run compares, and
their limits (``limits/<cell>.json``).

Scoring and stream cells compare, once the window has closed:

* ``missing_records``: records that the reference's own clean and
  data-quality filter sends to the scoring operator and that came back
  from it without their score, or with rows that are not theirs (limit 0);
* ``sink_mismatch``: window means that differ from the means of the
  program's own scores over the groups the engine's split makes (limit 0;
  cells whose job has no window operator have none);
* ``score_gap_nats``: the largest |score − reference score| over a sample
  of the scored records drawn from the seed, in nats.

Training cells compare the first steps, which the reference follows from
the same weights and batches:

* ``loss_gap``: the largest |loss − reference loss| / |reference loss| over
  those steps;
* ``grad_norm_gap``: the first gradient as the optimizer takes it (clipped),
  per leaf, worked out from the first moment after step 1 (m = (1 − b1)·g):
  the largest |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖);
* ``update_norm_gap``: the same for each leaf's change p − p0 after those
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move under Adam by round-off alone).
"""

from __future__ import annotations

import math
import statistics


def leaf_gaps(got: dict, want: dict, keep=None) -> list[float]:
    """Each leaf's |got − want| / max(want, the median leaf's want), over
    the leaves of ``want`` (all, or those in ``keep``)."""
    names = [n for n in want if keep is None or n in keep]
    med = statistics.median(want[n] for n in want)
    return [abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names]


def moving_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grad.values())
    return {n for n, v in ref_grad.items() if v >= 1e-3 * med}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number in ``limits`` compared with its
    limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        passed = v is not None and math.isfinite(v) and v <= spec["limit"]
        ok &= passed
        checks[name] = {"value": v, "limit": spec["limit"]}
    return ok, checks
