"""Grok-1-314B [hf:xai-org/grok-1; unverified]: 64L d_model=6144 48H
(GQA kv=8) MoE 8 experts top-2 (d_ff=32768) vocab=131072.  bf16 params."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, moe_experts=8, moe_top_k=2,
    moe_capacity_factor=1.25, moe_group_size=4096,
    norm_type="rmsnorm", mlp_kind="swiglu", rope_theta=1e4,
    param_dtype="bfloat16", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=256, moe_experts=4, moe_group_size=32,
    param_dtype="float32", act_dtype="float32")
