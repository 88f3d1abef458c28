"""Batched serving loop of the port: continuous-batching-lite request
server — the counterpart of ``repro.launch.serve``.

Requests (token prompts) arrive in waves; the server packs a wave into a
fixed-shape batch, runs prefill once, then decode steps until every
request has its token budget.  Per-wave prefill and decode wall time,
tokens out, throughput and the paper's DQ-aware objective (eq. 8 —
quality scoring of the generated stream costs latency, β prices it) are
reported.

The model carries its own parameters (an ``nn.Module``), so
:func:`serve_wave` takes no ``params``.  There is no jit and no buffer
donation: the cache is written in place under ``torch.inference_mode()``.
Times are the host clock around work flushed with
``torch.cuda.synchronize`` when the model is on the card.

Example (the card, reduced granite):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --requests 16 --batch 8 --prompt-len 32 --gen 16 --device cuda
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["ServeStats", "serve_wave", "main"]


class ServeStats:
    def __init__(self):
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.tokens_out = 0
        self.requests = 0

    def summary(self) -> dict:
        dec_tok_s = self.tokens_out / self.decode_s if self.decode_s else 0.0
        return {
            "requests": self.requests,
            "tokens_out": self.tokens_out,
            "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4),
            "decode_tok_per_s": round(dec_tok_s, 1),
        }


def _flush(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_wave(model, cfg, prompts: np.ndarray, gen_tokens: int,
               extras: dict | None = None, stats: ServeStats | None = None):
    """prompts (B, S) ints → (generated (B, gen_tokens) int32, stats).
    VLM / audio ``extras`` raise: those families come with ROADMAP A13b."""
    if extras:
        raise NotImplementedError(
            f"serving extras {sorted(extras)} (VLM / audio) are not ported "
            f"yet (ROADMAP A13b)")
    stats = stats or ServeStats()
    B, S = prompts.shape
    dev = model.device
    prefill = make_prefill_step(model, cfg)
    decode = make_decode_step(model, cfg)
    with torch.inference_mode():
        cache = model.init_cache(B, S + gen_tokens)
        batch = {"tokens": torch.as_tensor(np.asarray(prompts), device=dev)}
        _flush(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(batch, cache)
        _flush(dev)
        stats.prefill_s += time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
        tok = tok.to(torch.int32)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen_tokens - 1):
            tok, _, cache = decode(cache, S + i, tok)
            out.append(tok)
        _flush(dev)
        stats.decode_s += time.perf_counter() - t0
    stats.tokens_out += B * gen_tokens
    stats.requests += B
    return torch.cat(out, dim=1).cpu().numpy(), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--dq-fraction", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(f"family {cfg.family!r} serves with "
                                  f"extras (ROADMAP A13b)")
    model = build_model(cfg, device=args.device)
    model.init_params(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    stats = ServeStats()
    done = 0
    while done < args.requests:
        b = min(args.batch, args.requests - done)
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                               dtype=np.int32)  # fixed shape; pad last wave
        _, stats = serve_wave(model, cfg, prompts, args.gen, stats=stats)
        done += b
    s = stats.summary()
    # paper eq. (8): quality-adjusted objective for the serving deployment
    from repro_torch.streaming.quality import dq_latency_model
    lat = s["decode_s"] / max(s["tokens_out"], 1)
    s["latency_per_token_s"] = round(lat, 6)
    s["F_quality_adjusted"] = round(
        dq_latency_model(lat, args.dq_fraction, args.beta), 6)
    s["device"] = str(model.device)
    print(s)
    return s


if __name__ == "__main__":
    main()
