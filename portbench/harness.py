"""Run one cell of ``BENCHMARK.json`` once and build its result line.

:func:`main` is the command line (``portbench/run.py``); :func:`run_cell`
does the work for any device, so the tests can drive a whole run on the
CPU at a small size.  The pieces of a cell are found by name:
``configs/<config>.json`` (whose ``model.family`` names
``families/<family>.py``), ``traffic/<mix>.json`` (whose ``kind`` names
``drivers/<kind>.py``), ``limits/<cell>.json`` and, for each per-layer
metric, ``metrics/<metric>.py`` or, where there is none, the reader that
serves every metric of the name before its first dot,
``metrics/<stem>.py`` (``device_idle.score`` → ``device_idle.py``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def end_to_end_of(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str, here: Path = HERE):
    """The ``read`` of ``metrics/<name>.py``, or else of
    ``metrics/<stem>.py`` with ``stem`` the name before its first dot."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        path = here / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pieces(cell: dict, here: Path = HERE) -> tuple[dict, dict, dict]:
    """(configuration, traffic, limits) of a cell, from their files."""
    return (load_json(here / "configs" / f"{cell['config']}.json"),
            load_json(here / "traffic" / f"{cell['traffic']}.json"),
            load_json(here / "limits" / f"{cell['name']}.json"))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_process: float, config=None, traffic=None,
             limits=None) -> dict:
    """One run of cell ``name`` on ``device`` (a torch.device) → the result
    line as a dict (``checks`` last).  ``config``, ``traffic`` and
    ``limits`` replace the cell's files (the tests' small sizes)."""
    import torch

    from portbench import check, devtrace, drivers, stats
    cell = cell_of(bench, name)
    files = pieces(cell)
    config = config or files[0]
    traffic = traffic or files[1]
    limits = limits or files[2]
    cuda = device.type == "cuda"
    run = drivers.Run(name, config, traffic, devtrace.Spans(), {})
    driver = drivers.load(traffic["kind"]).Driver(run, seed, device, torch)
    driver.setup()
    drivers.synchronize(torch, device)
    prof = devtrace.Profiler(torch) if trace and cuda else None
    gc.collect()
    t0 = prof.start() if prof else time.perf_counter()
    setup_s = t0 - t_process
    t1 = driver.window(seconds, t0)
    run.trace = prof.stop() if prof else None
    drivers.synchronize(torch, device)
    run.window = (t0, t1)
    e2e = driver.end_to_end(t0)
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if not trace:
        for m in end_to_end_of(bench, name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in per_layer_of(bench, name):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": None, "attempted": driver.attempted(), "failed": 0,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        busy = stats.busy([(s, e) for _, s, e in run.trace.ops], t0, t1)
        dev["busy_s"], dev["window_s"] = busy, t1 - t0
        out["breakdown"] = devtrace.breakdown(run.trace, run.spans, t0, t1)
    driver.release()
    numbers, failed = driver.judge(limits)
    correct, checks = check.judge(numbers, limits)
    out["correct"], out["failed"] = correct, int(failed)
    out["checks"] = checks
    return out


def _power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the port's package src/repro_torch is not in "
              f"{ROOT}", file=sys.stderr)
        return 2
    bench = benchmark()
    cell = cell_of(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 2
    from portbench.guard import forbidden_modules
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t_process)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were "
              f"loaded: {bad}", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {_power()}",
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
