"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]: llama-arch dense,
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256, norm_type="rmsnorm",
    mlp_kind="swiglu", rope_theta=1e5,
    param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="deepseek-coder-33b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=160, vocab=256, act_dtype="float32")
