"""The port's LM substrate: model config and accounting (:mod:`.api`),
layers (:mod:`.layers`) and the dense decoder (:mod:`.transformer`)."""

from repro_torch.models.api import (ModelConfig, analytic_flops, build_model,
                                    count_params)

__all__ = ["ModelConfig", "build_model", "count_params", "analytic_flops"]
