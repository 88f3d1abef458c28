"""Granite-8B-code [arXiv:2405.04324; hf]: llama-arch dense,
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=49152, norm_type="rmsnorm",
    mlp_kind="swiglu", rope_theta=1e4,
    param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=256, act_dtype="float32")
