"""End-to-end trainer: data pipeline → train step → checkpoints → fault
tolerance — the counterpart of ``repro.launch.train`` on one card.

Supports ``--resume`` (the latest checkpoint and its pipeline cursor) and
``--die-at-step`` (a simulated node failure: the process exits 13 after
that step).  The model runs on the card unless ``--device cpu``; on the
card every weighted RMSNorm runs K7 and its backward kernel, and the rest
is PyTorch (attention on the reference's chunked route: training refuses
``attention_impl="pallas"``, see ``repro_torch.train.steps``).  Weights
are seeded random ones (seed 0), drawn on the model's device; the
VLM's image and the audio model's frame embeddings are seeded stubs,
drawn from ``torch.Generator``s (seeds 1 and 2, as the reference's keys;
not the reference's numbers).  AdamW keeps 8-bit moments for bf16
parameters and float32 moments otherwise, as the reference.

Example (the CPU, ~13M parameters; ``examples/train_lm.py``'s
configuration):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --layers 4 --width 128 --ff 256 --steps 200 --batch 8 \\
      --seq 64 --lr 1e-3 --dq-fraction 0.25 --log-every 20 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, Prefetcher, TokenStream
from repro_torch.models.api import build_model, stub_extras
from repro_torch.runtime.checkpoint import (latest_step, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step, require_trainable

__all__ = ["run_training", "main"]


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir=None, ckpt_every: int = 50, resume: bool = False,
                 die_at_step: int | None = None, lr: float = 3e-4,
                 dq_fraction: float = 0.0, log_every: int = 10,
                 seed: int = 0, keep: int = 3, device=None,
                 model=None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` × ``seq_len``
    tokens; returns {"losses": [(step, loss)], "model", "opt_state",
    "final_step"}.  ``model`` (optional) is the initial model, on its own
    device (``device`` is then not read), so a caller can start from given
    weights.  Raises ValueError for ``attention_impl="pallas"``."""
    require_trainable(cfg)      # before a model is built
    if model is None:
        model = build_model(cfg, device=device)
        model.init_params(torch.Generator(device=model.device)
                          .manual_seed(seed))
    opt_cfg = AdamWConfig(lr=lr, bits8=(cfg.param_dtype == "bfloat16"))
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg)
    pipe_cfg = PipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                              global_batch=global_batch, seed=seed,
                              dq_fraction=dq_fraction)
    stream = TokenStream(pipe_cfg)
    start_step = 0

    if resume and ckpt_dir is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            state, extra = restore_checkpoint(
                ckpt_dir, last, {"model": model.state_dict(),
                                 "opt": opt_state})
            model.load_state_dict(state["model"])
            opt_state = state["opt"]
            stream = TokenStream.from_state(pipe_cfg, extra["pipeline"])
            start_step = extra["step"]
            print(f"[train] resumed from step {start_step} "
                  f"(cursor={stream.cursor})")

    extras = stub_extras(cfg, global_batch, model.device)
    step_fn = make_train_step(model, cfg, opt_cfg)
    prefetch = Prefetcher(stream)
    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            batch = prefetch.next()
            consumed_cursor = int(batch.pop("_cursor"))
            batch.update(extras)
            opt_state, metrics = step_fn(opt_state, batch)
            if (step + 1) % log_every == 0 or step + 1 == steps:
                loss = float(metrics["loss"])
                losses.append((step + 1, loss))
                dt = time.time() - t0
                tok_s = (step + 1 - start_step) * global_batch * seq_len / dt
                print(f"[train] step {step + 1}/{steps} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"tok/s={tok_s:,.0f}")
            if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step + 1,
                                {"model": model.state_dict(),
                                 "opt": opt_state},
                                extra={"step": step + 1,
                                       "pipeline": {"cursor": consumed_cursor,
                                                    "seed": stream.cfg.seed}},
                                keep=keep)
            if die_at_step is not None and step + 1 == die_at_step:
                raise SystemExit(13)  # simulated node failure
    finally:
        prefetch.close()
    return {"losses": losses, "model": model, "opt_state": opt_state,
            "final_step": steps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="override n_layers (a depth cut)")
    ap.add_argument("--width", type=int, default=None,
                    help="override d_model")
    ap.add_argument("--ff", type=int, default=None, help="override d_ff")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--die-at-step", type=int, default=None)
    ap.add_argument("--dq-fraction", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(**{k: v for k, v in (("n_layers", args.layers),
                                           ("d_model", args.width),
                                           ("d_ff", args.ff))
                         if v is not None})
    return run_training(cfg, steps=args.steps, global_batch=args.batch,
                        seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every, resume=args.resume,
                        die_at_step=args.die_at_step, lr=args.lr,
                        dq_fraction=args.dq_fraction,
                        log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
