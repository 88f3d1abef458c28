"""Qwen3-32B [hf:Qwen/Qwen3-8B family; hf]: dense with qk_norm,
64L d_model=5120 64H (GQA kv=8, head_dim=128) d_ff=25600 vocab=151936."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    norm_type="rmsnorm", mlp_kind="swiglu", rope_theta=1e6,
    param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, act_dtype="float32")
