"""The port's LM substrate: model config and accounting (:mod:`.api`),
layers (:mod:`.layers`), the dense and MoE decoder (:mod:`.transformer`,
:mod:`.moe`), Mamba2 (:mod:`.mamba2`), the Zamba2 hybrid (:mod:`.hybrid`),
the VLM (:mod:`.vlm`) and the audio encoder–decoder (:mod:`.whisper`)."""

from repro_torch.models.api import (ModelConfig, analytic_flops, build_model,
                                    count_params)

__all__ = ["ModelConfig", "build_model", "count_params", "analytic_flops"]
