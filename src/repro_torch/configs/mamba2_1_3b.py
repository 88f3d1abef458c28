"""Mamba2-1.3B [arXiv:2405.21060; unverified]: SSD state-space model,
48L d_model=2048 (attn-free) vocab=50280, ssm_state=128.
Sub-quadratic: runs the long_500k cell."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=64,
    n_kv_heads=64, d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, ssm_conv=4, ssm_chunk=256, norm_type="rmsnorm",
    sub_quadratic=True, param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="mamba2-1.3b-smoke", n_layers=2, d_model=64, n_heads=16,
    n_kv_heads=16, vocab=256, ssm_state=16, ssm_head_dim=8, ssm_chunk=8,
    act_dtype="float32")
