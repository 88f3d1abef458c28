"""The port's LM substrate: model config and accounting (:mod:`.api`),
layers (:mod:`.layers`), the dense decoder (:mod:`.transformer`), Mamba2
(:mod:`.mamba2`) and the Zamba2 hybrid (:mod:`.hybrid`)."""

from repro_torch.models.api import (ModelConfig, analytic_flops, build_model,
                                    count_params)

__all__ = ["ModelConfig", "build_model", "count_params", "analytic_flops"]
