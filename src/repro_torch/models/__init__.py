"""The port's LM substrate: model config and accounting (:mod:`.api`),
layers (:mod:`.layers`), the dense and MoE decoder (:mod:`.transformer`,
:mod:`.moe`), Mamba2 (:mod:`.mamba2`), the Zamba2 hybrid (:mod:`.hybrid`),
the VLM (:mod:`.vlm`), the audio encoder–decoder (:mod:`.whisper`) and
the logical-axis sharding (:mod:`.sharding`)."""

from repro_torch.models.api import (ModelConfig, analytic_flops, build_model,
                                    count_params)

__all__ = ["ModelConfig", "build_model", "count_params", "analytic_flops"]
