"""OLMo-1B [arXiv:2402.00838; hf]: dense, non-parametric LayerNorm,
16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=8192 vocab=50304."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=50304, norm_type="layernorm_nonparam",
    mlp_kind="swiglu", rope_theta=1e4,
    param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="olmo-1b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, act_dtype="float32")
