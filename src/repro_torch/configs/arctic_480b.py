"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base; hf]:
35L d_model=7168 56H (GQA kv=8) MoE 128 experts top-2 (d_ff=4864 each)
+ parallel dense residual MLP, vocab=32000.  bf16 params."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=4864, vocab=32000, moe_experts=128, moe_top_k=2,
    moe_dense_residual=True, moe_capacity_factor=1.25, moe_group_size=4096,
    norm_type="rmsnorm", mlp_kind="swiglu", rope_theta=1e4,
    param_dtype="bfloat16", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab=256, moe_experts=4, moe_group_size=32,
    param_dtype="float32", act_dtype="float32")
