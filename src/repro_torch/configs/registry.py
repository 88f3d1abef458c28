"""Architecture registry of the port — the counterpart of
``repro.configs.registry``.

Each ported ``repro_torch/configs/<arch>.py`` defines ``CONFIG`` (exact
published dims) and ``SMOKE`` (a reduced config of the same family for CPU
tests).  The reference knows ten architectures; the port has the ones whose
model family it runs.  Asking for another raises ``KeyError`` naming the
roadmap item that brings it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.api import ModelConfig

__all__ = ["ARCH_IDS", "PORTED", "canonical_arch", "get_config",
           "get_smoke_config"]

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
PORTED = ("olmo_1b", "granite_8b", "deepseek_coder_33b", "qwen3_32b",
          "mamba2_1_3b")


def canonical_arch(arch: str) -> str:
    return arch.lower().replace(".", "_").replace("-", "_")


def _module(arch: str):
    arch = canonical_arch(arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP A13b); "
                       f"ported: {list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
