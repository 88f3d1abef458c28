"""A language model's forward, its loss, and the scores of records, in
plain float32 PyTorch, from a configuration's ``model`` sizes and the
benchmark's seeded weights (:mod:`portbench.weights`): the embedding, the
layers of the configuration's family (:mod:`portbench.families`), then
the head, RMSNorm and logits over every row of the padded table; the
per-token loss is logsumexp(logits) − logits[label].

RMSNorm's eps is 1e-6.  Nothing here is rounded below float32, and TF32
is off (:func:`exact_matmuls`), unless ``precision`` asks for a rounding
where the program holds its activations (each family's layer says where:
the residual stream, each norm's output, each projection's operands and
result, the conv's output, the scan's output, the gate): ``"fp8"``, the
control, float8 e4m3 with a per-tensor scale, in the forward and, under
grad, in the backward; ``"bf16"``, bfloat16, the program's own activation
type, to tell its rounding from a fault.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.families import family

EPS = 1e-6
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for matmuls and cuDNN inside
    the block, the settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _Round8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _q8(x)

    @staticmethod
    def backward(ctx, g):
        return _q8(g)


def rounding(precision: str):
    """The rounding applied where the program holds activations:
    ``"float32"`` none, ``"bf16"`` bfloat16, ``"fp8"`` float8 e4m3 (the
    control)."""
    if precision == "float32":
        return lambda t: t
    if precision == "bf16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if precision == "fp8":
        return _Round8.apply
    raise ValueError(f"precision is 'float32', 'bf16' or 'fp8', got "
                     f"{precision!r}")


def rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w


def token_losses(final_norm, head, x, labels, r) -> torch.Tensor:
    """Per-position logsumexp(logits) − logits[label] in float32 over
    every row of the padded head."""
    logits = r(rms(x, final_norm)) @ head
    return torch.logsumexp(logits, dim=-1) \
        - logits.gather(-1, labels[..., None]).squeeze(-1)


def _strip(group: dict, prefix: str) -> dict:
    return {n[len(prefix):]: t for n, t in group.items()}


@torch.no_grad()
def score_records(model: dict, seed: int, tokens: torch.Tensor,
                  precision: str = "float32", block: int = 8) -> torch.Tensor:
    """Each record's mean next-token loss, float64 (n,), for ``tokens`` (n,
    S) ids on the device, by layer over blocks of ``block`` records, each
    layer's weights made again from ``seed``."""
    r = rounding(precision)
    dev = tokens.device
    with exact_matmuls():
        embed = weights.make_group(model, seed, "embed", dev)["embed"]
        x = r(embed[tokens])
        del embed
        for group, fn in family(model).layers(model):
            w = _strip(weights.make_group(model, seed, group, dev),
                       group + ".")
            for lo in range(0, x.shape[0], block):
                x[lo:lo + block] = fn(w, x[lo:lo + block], model, r)
        end = weights.make_group(model, seed, "head", dev)
        out = []
        for lo in range(0, x.shape[0], 2):
            t = tokens[lo:lo + 2]
            ce = token_losses(end["final_norm"], end["head"],
                              x[lo:lo + 2, :-1], t[:, 1:], r)
            out.append(ce.double().mean(-1))
    return torch.cat(out)


def all_weights(model: dict, seed: int, device) -> dict:
    """Every leaf (name → float32 tensor) of the seed's weights."""
    out = {}
    for g in weights.groups(model):
        out.update((n, t.clone())
                   for n, t in weights.make_group(model, seed, g,
                                                  device).items())
    return out


def loss_sum(params: dict, model: dict, tokens, labels, mask, r):
    """Σ loss·mask over the rows given, each layer checkpointed (its
    activations made again in the backward)."""
    x = r(params["embed"][tokens])
    for group, fn in family(model).layers(model):
        p = group + "."
        w = _strip({n: t for n, t in params.items() if n.startswith(p)}, p)
        x = checkpoint(fn, w, x, model, r, use_reentrant=False)

    def head(x):
        return (token_losses(params["final_norm"], params["head"], x, labels,
                             r) * mask).sum()

    return checkpoint(head, x, use_reentrant=False)
