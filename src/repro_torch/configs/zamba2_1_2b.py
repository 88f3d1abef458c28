"""Zamba2-1.2B [arXiv:2411.15242; hf]: hybrid Mamba2 backbone + one SHARED
attention block (single param set) applied every 6 SSM layers.
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64.
Sub-quadratic: runs the long_500k cell."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, ssm_state=64,
    ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    shared_attn_every=6, norm_type="rmsnorm", mlp_kind="swiglu",
    rope_theta=1e4, sub_quadratic=True,
    param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=8, ssm_chunk=8,
    shared_attn_every=2, act_dtype="float32")
