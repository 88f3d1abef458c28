"""Architecture registry of the port — the counterpart of
``repro.configs.registry``.

Each ``repro_torch/configs/<arch>.py`` defines ``CONFIG`` (exact published
dims) and ``SMOKE`` (a reduced config of the same family for CPU tests),
the reference's own, for all ten of its architectures.  The input shapes
of the dry run's cells (``Shape``, ``SHAPES``) and which cells it skips
are the reference's (``repro.configs.registry:34-91``).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.api import ModelConfig

__all__ = ["ARCH_IDS", "ALIASES", "Shape", "SHAPES", "canonical_arch",
           "get_config", "get_smoke_config", "shape_skip_reason",
           "runnable_cells", "skipped_cells"]

# every architecture of the reference's registry, in its order
ARCH_IDS = [
    "olmo_1b",
    "granite_8b",
    "deepseek_coder_33b",
    "qwen3_32b",
    "mamba2_1_3b",
    "arctic_480b",
    "grok_1_314b",
    "zamba2_1_2b",
    "llama_3_2_vision_11b",
    "whisper_large_v3",
]


# CLI-friendly aliases (--arch olmo-1b etc.)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def canonical_arch(arch: str) -> str:
    return arch.lower().replace(".", "_").replace("-", "_")


def _module(arch: str):
    arch = canonical_arch(arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_skip_reason(cfg: ModelConfig, shape: Shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k requires sub-quadratic sequence mixing; "
                f"{cfg.name} is pure full-attention (skip noted in DESIGN.md)")
    return None


def runnable_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if shape_skip_reason(cfg, shape) is None:
                cells.append((arch, sname))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            r = shape_skip_reason(cfg, shape)
            if r:
                out.append((arch, sname, r))
    return out
