"""The readings the limits of ``limits/<cell>.json`` are set from, taken on
the card at the cell's own size: the program's numbers on many seeds, the
control's (the reference itself in float8, the driver's ``control``) and
each planted fault's (the driver's ``FAULTS``) on a few.  One process
reads them all, so the weights are made again for each seed but nothing
else is paid twice.  It is no part of a benchmark run::

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        --control 3 --faults 3 [--seconds 3]

prints one JSON line a reading.  A training cell's numbers come from its
set-up steps, so ``--seconds 0`` runs no window there.

``--flat`` reads, in a scoring cell, what the records that hold one token
repeated (a dropout's row once cleaned; no limit parts bfloat16 from the
control on them) read on each side: the program in its configuration's
precision twice on the same seed, the program with float32 activations,
and the reference rounded to bfloat16 and to float8, each against the
reference in float32::

    python3 portbench/calibrate.py --workload mamba2-1.3b.score --flat \\
        --at 11 4 0
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import drivers, harness  # noqa: E402
from portbench.devtrace import Spans  # noqa: E402
from portbench.drivers._scoring import flat  # noqa: E402
from portbench.reference import lm as ref  # noqa: E402

SEED0 = 0x5EED_0000_0017


def sound(cell, seed, seconds, device, config, traffic):
    """The driver after its set-up and a window of ``seconds`` (none at
    0), its program's state freed."""
    run = drivers.Run(cell, config, traffic, Spans(), {})
    d = drivers.load(traffic["kind"]).Driver(run, seed, device, torch)
    d.setup()
    if seconds > 0:
        d.window(seconds, time.perf_counter())
    d.release()
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--at", type=int, nargs="+",
                    help="the seeds' places, in place of --first/--seeds")
    ap.add_argument("--flat", action="store_true")
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    config, traffic, limits = harness.pieces(cell)
    device = torch.device("cuda", 0)
    kind = drivers.load(traffic["kind"])
    places = args.at or range(args.first, args.first + args.seeds)
    seeds = [SEED0 + 7919 * k for k in places]

    def emit(**kw):
        print(json.dumps({"cell": args.workload, **kw}), flush=True)

    def reading(seed, what, fn):
        t = time.perf_counter()
        out = fn()
        emit(seed=seed, what=what, **out, seconds=time.perf_counter() - t)

    if args.flat:
        for seed in seeds:
            reading(seed, "flat", lambda: flat_readings(
                args.workload, seed, args.seconds, device, config, traffic,
                limits))
        return 0
    for i, seed in enumerate(seeds):
        d = None

        def program():
            nonlocal d
            d = sound(args.workload, seed, args.seconds, device, config,
                      traffic)
            numbers, failed = d.judge(limits)
            return {"numbers": numbers, "failed": failed, **detail(d)}

        reading(seed, "program", program)
        if i < args.control:
            reading(seed, "control fp8", lambda: {"numbers": d.control()})
        for fault, plant in kind.FAULTS.items() if i < args.faults else ():
            if fault == "state_unchanged":
                continue    # reads 1 by the measure, no run needed

            def faulty():
                with plant():
                    f = sound(args.workload, seed, args.seconds, device,
                              config, traffic)
                if hasattr(d, "reference"):
                    numbers = kind.against(f.first_losses, f.first_grad,
                                           f.change, d.reference)
                else:
                    numbers, _ = f.judge(limits)
                return {"numbers": numbers}

            reading(seed, "fault " + fault, faulty)
        del d
        torch.cuda.empty_cache()
    return 0


def detail(d) -> dict:
    """A scoring run's gap on each sampled record; a training run's three
    leaves with the widest gaps of each number."""
    if not hasattr(d, "reference"):
        return {"gaps": d.gaps.tolist()}
    want = d.reference
    med_g = float(np.median(list(want["first_grad"].values())))
    med_c = float(np.median(list(want["change"].values())))

    def top(got, ref_, med):
        gaps = {n: abs(got[n] - ref_[n]) / max(ref_[n], med) for n in ref_}
        return [[n, gaps[n], got[n], ref_[n]]
                for n in sorted(gaps, key=gaps.get, reverse=True)[:3]]

    return {"losses": [d.first_losses, want["losses"]],
            "grad_worst": top(d.first_grad, want["first_grad"], med_g),
            "change_worst": top(d.change, want["change"], med_c),
            "medians": [med_g, med_c]}


def flat_readings(cell, seed, seconds, device, config, traffic,
                  limits) -> dict:
    """What the flat records read on each side (see the module's text):
    the largest gap to the reference in float32 of each, the program's
    spread over one run's flat records, and the largest difference between
    two runs of the program on the same seed."""
    f32 = copy.deepcopy(config)
    f32["model"]["act_dtype"] = "float32"
    runs = {}
    for name, cfg in (("program", config), ("again", config),
                      ("program_f32", f32)):
        try:
            d = sound(cell, seed, seconds, device, cfg, traffic)
        except Exception as e:     # a path the program may not have
            runs[name] = repr(e)
            continue
        numbers, _ = d.judge(limits)
        toks = d.tokens()
        rows = flat(toks)
        runs[name] = (d.scores[rows], toks[rows], numbers)
        del d
        torch.cuda.empty_cache()
    got, toks, numbers = runs["program"]
    out = {"flat_records": int(len(got)),
           "flat_inputs": int(len(np.unique(toks, axis=0))),
           "numbers": numbers}
    if not len(got):
        return out
    row = torch.as_tensor(toks[:1], device=device)
    model = config["model"]
    want = float(ref.score_records(model, seed, row)[0])
    gaps = {"program": float(np.abs(got - want).max())}
    if isinstance(runs["program_f32"], str):
        out["program_f32_error"] = runs["program_f32"]
    else:
        gaps["program_f32"] = float(np.abs(runs["program_f32"][0] - want)
                                    .max())
        out["numbers_f32"] = runs["program_f32"][2]
    for p in ("bf16", "fp8"):
        gaps["reference_" + p] = abs(float(ref.score_records(
            model, seed, row, precision=p)[0]) - want)
    n = min(len(got), len(runs["again"][0]))
    return {**out, "reference": want, "gaps": gaps,
            "program_spread": float(got.max() - got.min()),
            "repeat_diff": float(np.abs(got[:n] - runs["again"][0][:n])
                                 .max())}


if __name__ == "__main__":
    sys.exit(main())
