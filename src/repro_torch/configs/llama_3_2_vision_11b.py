"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified]:
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, gated
cross-attention to image patches every 5 layers.  Vision tower is a
STUB: batch["image_embeds"] carries precomputed (B, 1601, d_model) patch
embeddings."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, cross_attn_every=5,
    n_image_tokens=1601, norm_type="rmsnorm", mlp_kind="swiglu",
    rope_theta=5e5, param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="llama-3.2-vision-11b-smoke", n_layers=4, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=128, vocab=256, cross_attn_every=2, n_image_tokens=9,
    act_dtype="float32")
