"""Whisper-large-v3 backbone [arXiv:2212.04356; unverified]: enc-dec,
32L(dec)+32L(enc) d_model=1280 20H (kv=20) d_ff=5120 (GELU) vocab=51866.
Conv/mel frontend is a STUB: batch["audio_frames"] carries precomputed
(B, 1500, d_model) frame embeddings.  Norms simplified to RMSNorm
(backbone only), as in the reference."""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866, encoder_layers=32,
    n_audio_frames=1500, mlp_kind="gelu", norm_type="rmsnorm",
    rope_theta=1e4, param_dtype="float32", act_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="whisper-large-v3-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, encoder_layers=2, n_audio_frames=8,
    act_dtype="float32")
