"""``train_stream``: ``make_train_step`` with AdamW, fed by the synthetic
stream's ``TokenStream`` through its ``Prefetcher``.  Reports
``train_tokens_per_s``: the tokens of every step launched in the window,
over the time from its start to the closing ``synchronize()``.

Faults: ``half_batch`` (the gradient of the first half of the batch's
rows, their mean), ``leaf_doubled`` (the gradient of one projection
doubled where it is made), ``state_unchanged`` (the update returns the
parameters and the optimizer state as they were).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench import check, weights
from portbench.drivers import Run, program_config, swapped, synchronize
from portbench.families import family
from portbench.reference import lm as ref
from portbench.reference import optim as ref_optim
from portbench.reference import stream as ref_stream


class Driver:
    """The first ``reference_steps`` steps are set-up and the reference
    follows them; the window runs the steps after them."""

    def __init__(self, run: Run, seed: int, device, torch):
        self.run, self.seed, self.device, self.torch = run, seed, device, torch
        self.tr = run.traffic

    def setup(self) -> None:
        from repro_torch.data import pipeline
        from repro_torch.models import build_model
        from repro_torch.train import optim, steps

        torch, run, tr = self.torch, self.run, self.tr
        cfg = program_config(run.config, attention_impl="reference")
        self.model = build_model(cfg, device=self.device)
        self.params = dict(self.model.named_parameters())
        weights.load_into(self.params, run.model, self.seed)
        self.opt_cfg = optim.AdamWConfig(lr=tr["lr"],
                                         bits8=cfg.param_dtype == "bfloat16")
        self.opt_state = optim.adamw_init(self.params, self.opt_cfg)
        self.step_fn = steps.make_train_step(self.model, cfg, self.opt_cfg)
        self.prefetch = pipeline.Prefetcher(pipeline.TokenStream(
            pipeline.PipelineConfig(vocab=run.model["vocab"],
                                    seq_len=tr["seq_len"],
                                    global_batch=tr["batch"], seed=self.seed,
                                    dq_fraction=tr["dq_fraction"])),
            depth=tr["prefetch_depth"])
        self.losses = []
        for k in range(tr["reference_steps"]):
            self.one_step()
            if k == 0:
                with torch.no_grad():
                    b1 = self.opt_cfg.b1
                    self.first_grad = {
                        n: torch.linalg.vector_norm(m.float()) / (1 - b1)
                        for n, m in self.opt_state["m"].items()}
        with torch.no_grad():
            self.change = {}
            for g in weights.groups(run.model):
                for n, p0 in weights.make_group(run.model, self.seed, g,
                                                self.device).items():
                    self.change[n] = torch.linalg.vector_norm(
                        self.params[n].float() - p0)
        synchronize(torch, self.device)
        self.first_losses = [float(v) for v in self.losses]
        self.losses, self.window_losses, self.n = [], [], 0

    def one_step(self) -> None:
        spans = self.run.spans
        with spans("data.next"):
            batch = self.prefetch.next()
        batch.pop("_cursor")
        with spans("train.step"):
            self.opt_state, met = self.step_fn(self.opt_state, batch)
        self.losses.append(met["loss"])

    def window(self, seconds: float, t0: float) -> float:
        n = 0
        while time.perf_counter() < t0 + seconds:
            self.one_step()
            n += 1
        synchronize(self.torch, self.device)
        t1 = time.perf_counter()
        self.n = n
        tr = self.tr
        self.run.counters.update(
            steps=n, model_flops=n * family(self.run.model).model_flops(
                self.run.model, tr["batch"], tr["seq_len"], "train"))
        self.window_losses = [float(v) for v in self.losses]
        return t1

    def end_to_end(self, t0: float) -> dict:
        tokens = self.tr["batch"] * self.tr["seq_len"]
        return {"train_tokens_per_s":
                self.n * tokens / (self.run.window[1] - t0)}

    def attempted(self) -> int:
        return self.n

    def release(self) -> None:
        self.prefetch.close()
        self.first_grad = {n: float(v) for n, v in self.first_grad.items()}
        self.change = {n: float(v) for n, v in self.change.items()}
        del self.model, self.params, self.opt_state, self.step_fn
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def judge(self, limits: dict):
        self.reference = follow(self.run.config, self.tr, self.seed,
                                self.device, self.torch)
        numbers = against(self.first_losses, self.first_grad, self.change,
                          self.reference)
        failed = sum(not np.isfinite(v) for v in self.window_losses)
        return numbers, failed

    def control(self) -> dict:
        """The reference's steps in float8 against its steps in float32
        (:meth:`judge` made those)."""
        c = follow(self.run.config, self.tr, self.seed, self.device,
                   self.torch, precision="fp8")
        return against(c["losses"], c["first_grad"], c["change"],
                       self.reference)


def against(losses: list, first_grad: dict, change: dict, want: dict) -> dict:
    """The training numbers of ``check``: the first steps' losses, first
    gradient and change per leaf against the reference's (:func:`follow`),
    by the worst leaf and by the median leaf."""
    grad = check.leaf_gaps(first_grad, want["first_grad"])
    moved = check.leaf_gaps(change, want["change"],
                            check.moving_leaves(want["grad"]))
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, want["losses"])),
        "grad_norm_gap": max(grad),
        "grad_norm_gap_median": float(np.median(grad)),
        "update_norm_gap": max(moved)}


def follow(config: dict, tr: dict, seed: int, device, torch,
           precision: str = "float32") -> dict:
    """The reference's first ``reference_steps`` steps from the seed's
    weights on the stream's first batches: each step's loss, each leaf's
    first gradient as AdamW takes it (clipped) and unclipped, and each
    leaf's change after the steps."""
    model = config["model"]
    r = ref.rounding(precision)
    cfg = ref_optim.AdamW(lr=tr["lr"])
    rows = tr["reference_rows"]
    with ref.exact_matmuls():
        params = ref.all_weights(model, seed, device)
        for p in params.values():
            p.requires_grad_(True)
        state, losses = {}, []
        for k in range(tr["reference_steps"]):
            b = ref_stream.stream_batch(seed, k, model["vocab"],
                                        tr["seq_len"], tr["batch"],
                                        tr["dq_fraction"])
            tok, lab, mask = (torch.as_tensor(b[n], device=device)
                              for n in ("tokens", "labels", "loss_mask"))
            tok, lab = tok.long(), lab.long()
            denom = mask.sum().clamp_min(1.0)
            for p in params.values():
                p.grad = None
            total = 0.0
            for lo in range(0, tok.shape[0], rows):
                part = ref.loss_sum(params, model, tok[lo:lo + rows],
                                    lab[lo:lo + rows], mask[lo:lo + rows],
                                    r) / denom
                part.backward()
                total += float(part.detach())
            losses.append(total)
            grads = {n: p.grad for n, p in params.items()}
            if k == 0:
                unclipped = {n: float(torch.linalg.vector_norm(g))
                             for n, g in grads.items()}
                first = {n: float(torch.linalg.vector_norm(g)) for n, g in
                         ref_optim.clipped(grads, cfg).items()}
            ref_optim.step({n: p.data for n, p in params.items()}, grads,
                           state, cfg)
        change = {}
        with torch.no_grad():
            for g in weights.groups(model):
                for n, p0 in weights.make_group(model, seed, g,
                                                device).items():
                    change[n] = float(torch.linalg.vector_norm(
                        params[n] - p0))
    return {"losses": losses, "first_grad": first, "grad": unclipped,
            "change": change}


def _half(make_grad_fn):
    def broken(model, cfg):
        grad_fn = make_grad_fn(model, cfg)

        def half(batch):
            n = next(iter(batch.values())).shape[0]
            return grad_fn({k: v[: max(n // 2, 1)] for k, v in batch.items()})
        return half
    return broken


LEAF = "blocks.0.wx"


def _doubled(make_grad_fn):
    def broken(model, cfg):
        grad_fn = make_grad_fn(model, cfg)

        def doubled(batch):
            loss, aux, grads = grad_fn(batch)
            grads[LEAF] = grads[LEAF] * 2
            return loss, aux, grads
        return doubled
    return broken


def _unchanged(adamw_update):
    def broken(grads, opt_state, params, cfg):
        import torch
        return params, opt_state, torch.zeros(())
    return broken


def _plant(name, fn):
    def plant():
        from repro_torch.train import steps
        return swapped(steps, name, fn)
    return plant


FAULTS = {"half_batch": _plant("make_grad_fn", _half),
          "leaf_doubled": _plant("make_grad_fn", _doubled),
          "state_unchanged": _plant("adamw_update", _unchanged)}
