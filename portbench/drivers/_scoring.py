"""The example's streaming job on the program's engine, shared by the
scoring kinds: ingest → clean → dq_check → lm_score (→ window_mean), as
``examples/geo_placement.py`` builds it, through
``StreamingEngine.run_batch`` on the example's fleet; the numbers that
decide ``correct`` in a scoring cell; its control; its faults.

Faults: ``half_batch`` (the operator scores the first half of its rows,
rounded down, and leaves the rest out), ``answers_shifted`` (each record
gets the score the operator made for the record before it).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench import weights
from portbench.drivers import Run, program_config, seeded, swapped
from portbench.families import family
from portbench.fleet import example_fleet
from portbench.reference import lm as ref
from portbench.reference import stream as ref_stream


def flat(tokens: np.ndarray) -> np.ndarray:
    """Which rows hold one token repeated (a sensor that sent nothing
    leaves such a row once it is cleaned)."""
    return np.all(tokens == tokens[:, :1], axis=1)


class Scoring:
    """The job, and its judgement once the window has closed."""

    def __init__(self, run: Run, seed: int, device, torch):
        self.run, self.seed, self.device, self.torch = run, seed, device, torch
        self.tr = run.traffic
        # (rows, [(shard rows, scores)], [window io]) of each batch kept
        self.batches = []
        self.cur = None

    def setup(self) -> None:
        from repro_torch.core.devices import ExplicitFleet
        from repro_torch.models import build_model
        from repro_torch.streaming import StreamGraph, StreamingEngine
        from repro_torch.streaming import operators as sops

        run, tr = self.run, self.tr
        cfg = program_config(run.config,
                             attention_impl=tr["attention_impl"])
        self.model = build_model(cfg, device=self.device)
        weights.load_into(dict(self.model.named_parameters()), run.model,
                          self.seed)
        vocab = run.model["vocab"]
        ops = []
        for spec in tr["dag"]:
            kind, name = spec["op"], spec["name"]
            if kind == "source":
                op = sops.source(name)
            elif kind == "clean":
                op = sops.map_op(name, lambda r: np.clip(r, 0, vocab - 1),
                                 work=spec["work"])
            elif kind == "quality":
                op = sops.quality_op(name, threshold=spec["threshold"],
                                     work=spec["work"])
            elif kind == "model":
                op = sops.model_op(name, self.model, work=spec["work"])
            elif kind == "window":
                op = sops.window_agg(name, window=spec["window"],
                                     work=spec["work"])
            else:
                raise ValueError(f"unknown operator kind {kind!r}")
            op.fn = self._tapped(op.fn, name, kind)
            ops.append(op)
        graph = StreamGraph(ops, [(i, i + 1) for i in range(len(ops) - 1)])
        f = example_fleet()
        fleet = ExplicitFleet(com_cost=f["com"], speed=f["speed"],
                              region=f["region"])
        share = np.asarray(tr["placement"], dtype=np.float64)
        self.x = share / share.sum(axis=1, keepdims=True)
        self.engine = StreamingEngine(graph, fleet, self.x,
                                      alpha=tr["alpha"],
                                      device_speed=f["speed"])
        self.kinds = [s["op"] for s in tr["dag"]]

    def _tapped(self, fn, name: str, kind: str):
        spans = self.run.spans

        def tapped(rows):
            t0 = time.perf_counter()
            out = fn(rows)
            spans.add("op." + name, t0, time.perf_counter())
            if self.cur is not None and kind in ("model", "window"):
                self.cur[kind].append((rows, out))
            return out

        return tapped

    def run_batch(self, rows: np.ndarray, keep: bool = True):
        self.cur = {"model": [], "window": []} if keep else None
        with self.run.spans("engine.run_batch"):
            report = self.engine.run_batch(rows)
        if keep:
            self.batches.append((rows, self.cur["model"],
                                 self.cur["window"]))
        self.cur = None
        return report

    def count_window(self) -> None:
        """The window's counters, once it has closed."""
        shards = [len(r) for _, calls, _ in self.batches for r, _ in calls]
        n = sum(shards)
        self.run.counters.update(
            batches=len(self.batches), scored_records=n, lm_shards=shards,
            model_flops=family(self.run.model).model_flops(
                self.run.model, n, self.tr["tokens_per_record"], "forward"))

    def release(self) -> None:
        del self.engine, self.model
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # ------------------------------------------------------------ check --
    def judge_numbers(self) -> dict:
        """``missing_records`` and, where the job has a window operator,
        ``sink_mismatch``; keeps the records that came back whole and their
        scores for :meth:`score_gap`."""
        tr, model = self.tr, self.run.model
        vocab = model["vocab"]
        quality = next(s for s in tr["dag"] if s["op"] == "quality")
        win = next((s for s in tr["dag"] if s["op"] == "window"), None)
        missing = mismatch = 0
        records, scores = [], []
        for rows, calls, wins in self.batches:
            want = ref_stream.scored_rows(rows, vocab, quality["threshold"])
            got = [r for r, _ in calls]
            got = np.concatenate(got) if got else want[:0]
            outs = [np.asarray(o).reshape(-1) for _, o in calls]
            served = [len(o) == len(r) for (r, _), o in zip(calls, outs)]
            n = min(len(want), len(got))
            same = np.all(got[:n] == want[:n], axis=1) if n else \
                np.zeros(0, bool)
            got_scores = np.concatenate(outs) if outs else np.zeros(0)
            ok = same & (np.arange(n) < len(got_scores)) & all(served)
            missing += len(want) - int(ok.sum()) + max(len(got) - len(want),
                                                       0)
            if all(served) and len(got) == len(want):
                records.append(got)
                scores.append(got_scores)
            if win is not None:
                mismatch += self._window_mismatch(got_scores, wins, win)
        self.records = np.concatenate(records) if records else None
        self.scores = np.concatenate(scores) if scores else None
        numbers = {"missing_records": float(missing)}
        if win is not None:
            numbers["sink_mismatch"] = float(mismatch)
        return numbers

    def _window_mismatch(self, scores: np.ndarray, wins, spec) -> int:
        w = spec["window"]
        idx = self.kinds.index("window")
        want = []
        for lo, hi in ref_stream.split_rows(len(scores), self.x[idx]):
            part = scores[lo:hi]
            m = (len(part) // w) * w
            want.append(part[:m].reshape(-1, w).mean(axis=1))
        want = np.concatenate(want) if want else np.zeros(0)
        got = np.concatenate([np.asarray(o).reshape(-1) for _, o in wins]) \
            if wins else np.zeros(0)
        n = min(len(want), len(got))
        bad = np.abs(got[:n] - want[:n]) > 1e-6 * np.maximum(1.0, np.abs(
            want[:n]))
        return int(bad.sum()) + abs(len(want) - len(got))

    def tokens(self) -> np.ndarray:
        vocab = self.run.model["vocab"]
        return np.clip(self.records, 0, vocab - 1).astype(np.int64)

    def score_gap(self) -> float:
        """The largest gap in nats over a seeded sample of the scored
        records (``sample_records``).  Flat records (:func:`flat`) are left
        out: their single repeated prediction carries the model's per-token
        error unaveraged, which in bfloat16 reaches what float8 reaches on
        some weights, so no limit parts the two on them; the program's
        float32 path and the reference rounded to bfloat16 show that
        rounding for what it is (``calibrate.py --flat``)."""
        torch = self.torch
        toks = self.tokens()
        idx = np.flatnonzero(~flat(toks))
        pick = np.sort(seeded(self.seed, 1).choice(
            idx, min(self.tr["sample_records"], len(idx)), replace=False))
        self.sample = torch.as_tensor(toks[pick], device=self.device)
        self.want = ref.score_records(self.run.model, self.seed, self.sample,
                                      block=self.tr["reference_block"]
                                      ).cpu().numpy()
        self.gaps = np.abs(self.scores[pick] - self.want)
        return float(self.gaps.max()) if len(pick) else 0.0

    def judge(self, limits: dict):
        numbers = self.judge_numbers()
        failed = int(numbers["missing_records"])
        if self.records is not None and len(self.records):
            numbers["score_gap_nats"] = self.score_gap()
            failed += int((self.gaps > limits["score_gap_nats"]["limit"])
                          .sum())
        return numbers, failed

    def control(self) -> dict:
        """The reference in float8 on the records :meth:`score_gap` drew,
        against the reference in float32."""
        got = ref.score_records(self.run.model, self.seed, self.sample,
                                precision="fp8",
                                block=self.tr["reference_block"])
        self.control_gaps = np.abs(got.cpu().numpy() - self.want)
        return {"score_gap_nats": float(self.control_gaps.max())}


def _half(model_op):
    def broken(name, model, **kw):
        op = model_op(name, model, **kw)
        fn = op.fn

        def half(rows):
            keep = len(rows) // 2
            return fn(rows[:keep]) if keep else np.zeros((0, 1), np.float32)
        op.fn = half
        return op
    return broken


def _shifted(model_op):
    def broken(name, model, **kw):
        op = model_op(name, model, **kw)
        fn, carry = op.fn, []

        def shifted(rows):
            out = fn(rows)
            prev = carry[-1] if carry else out[:1]
            carry[:] = [out[-1:]]
            return np.concatenate([prev, out[:-1]])
        op.fn = shifted
        return op
    return broken


def _plant(fn):
    def plant():
        from repro_torch.streaming import operators
        return swapped(operators, "model_op", fn)
    return plant


FAULTS = {"half_batch": _plant(_half), "answers_shifted": _plant(_shifted)}
