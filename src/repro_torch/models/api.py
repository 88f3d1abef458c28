"""Model API of the port: config, builder, analytic FLOP/param accounting —
the counterpart of ``repro.models.api``.

``ModelConfig`` is the reference's dataclass field for field, so one config
describes the same model in both packages; its dtype properties return
torch dtypes.  ``build_model(cfg, device)`` returns a module exposing

  init_params(generator)        -> fills the parameters in place
  forward(batch)                -> (logits, aux_loss)

  init_cache(batch, max_seq)    -> a zeroed cache on the model's device
  prefill(batch, cache)         -> (logits_last, cache)
  decode_step(cache, pos, tokens) -> (logits, cache)

for every family of the reference: the dense and MoE decoders, the Mamba2
SSM, the Zamba2 hybrid, the VLM and the audio encoder–decoder.  ``batch``
is a dict: always ``tokens`` (B, S) ints; the VLM adds ``image_embeds``
(B, n_img, d), the audio model ``audio_frames`` (B, n_frames, d) — the
modality frontends are stubs, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "build_model", "stub_extras", "count_params",
           "analytic_flops"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    norm_type: str = "rmsnorm"
    qk_norm: bool = False
    mlp_kind: str = "swiglu"
    rope_theta: float | None = 1e4
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_dense_residual: bool = False
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 4096
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block applied every k ssm blocks
    shared_attn_every: int = 0
    # VLM: cross-attention to image embeddings every k self-attn layers
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # audio enc-dec
    encoder_layers: int = 0
    n_audio_frames: int = 0
    # numerics / implementation
    param_dtype: str = "float32"
    act_dtype: str = "bfloat16"
    attention_impl: str = "reference"  # reference | pallas (K5)
    attn_chunk: int = 256
    remat: str = "full"  # full | dots | none (models.transformer.remat_wrap)
    # kept for parity with the reference's configs; the port's layer stack
    # is a Python loop
    scan_layers: bool = True
    sub_quadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables pad the vocab to a multiple of 256 (as the
        reference does for even vocab sharding); analytics (count_params)
        use the true vocab."""
        return -(-self.vocab // 256) * 256

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def build_model(cfg: ModelConfig, device=None):
    """The model for ``cfg`` on ``device`` (``None``: the card, raising
    without CUDA), parameters allocated but not initialised: call
    ``init_params`` or load them (``repro_torch.convert``).  As the
    reference: ``dense`` and ``moe`` build a ``DecoderLM`` (with MoE blocks
    when ``moe_experts`` > 0), ``ssm`` a ``Mamba2LM`` and ``hybrid`` a
    ``Zamba2LM`` (both ignore ``moe_experts``), ``vlm`` a ``VisionLM``,
    ``audio`` an ``EncDecLM``; a family's missing sizes raise ValueError,
    as the reference asserts them."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg, device=device)
    if cfg.family == "ssm":
        from repro_torch.models.mamba2 import Mamba2LM
        return Mamba2LM(cfg, device=device)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import Zamba2LM
        return Zamba2LM(cfg, device=device)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VisionLM
        return VisionLM(cfg, device=device)
    if cfg.family == "audio":
        from repro_torch.models.whisper import EncDecLM
        return EncDecLM(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family}")


def stub_extras(cfg: ModelConfig, batch: int, device) -> dict:
    """The modality frontends' stubs: fixed seeded float32 image (VLM,
    seed 1) or frame (audio, seed 2) embeddings for ``batch`` rows."""
    def draw(seed, n):
        return torch.randn((batch, n, cfg.d_model), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(seed))

    if cfg.family == "vlm":
        return {"image_embeds": draw(1, cfg.n_image_tokens)}
    if cfg.family == "audio":
        return {"audio_frames": draw(2, cfg.n_audio_frames)}
    return {}


# ------------------------------------------------------- analytic counts ---

def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.hd
    p = cfg.d_model * cfg.n_heads * hd * 2  # wq, wo
    p += cfg.d_model * cfg.n_kv_heads * hd * 2  # wk, wv
    if cfg.qk_norm:
        p += 2 * hd
    return p


def _mlp_params(cfg: ModelConfig, d_ff: int | None = None) -> int:
    d_ff = d_ff or cfg.d_ff
    mult = 3 if cfg.mlp_kind == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts from the config."""
    emb = cfg.vocab * cfg.d_model
    head = cfg.vocab * cfg.d_model
    norms = 2 * cfg.d_model if cfg.norm_type == "rmsnorm" else 0
    total = emb + head
    active = emb + head

    if cfg.family in ("dense", "moe", "vlm"):
        per_layer = _attn_params(cfg) + norms
        if cfg.moe_experts:
            router = cfg.d_model * cfg.moe_experts
            experts = cfg.moe_experts * _mlp_params(cfg)
            act_ffn = cfg.moe_top_k * _mlp_params(cfg)
            if cfg.moe_dense_residual:
                experts += _mlp_params(cfg)
                act_ffn += _mlp_params(cfg)
            total += cfg.n_layers * (per_layer + router + experts)
            active += cfg.n_layers * (per_layer + router + act_ffn)
        else:
            total += cfg.n_layers * (per_layer + _mlp_params(cfg))
            active += cfg.n_layers * (per_layer + _mlp_params(cfg))
        if cfg.family == "vlm" and cfg.cross_attn_every:
            n_cross = cfg.n_layers // cfg.cross_attn_every
            total += n_cross * (_attn_params(cfg) + norms)
            active += n_cross * (_attn_params(cfg) + norms)
    elif cfg.family == "ssm":
        per = _mamba2_params(cfg)
        total += cfg.n_layers * per
        active += cfg.n_layers * per
    elif cfg.family == "hybrid":
        per = _mamba2_params(cfg)
        total += cfg.n_layers * per
        active += cfg.n_layers * per
        shared = _attn_params(cfg) + _mlp_params(cfg) + norms
        total += shared  # one parameter set, reused
        n_apps = max(cfg.n_layers // max(cfg.shared_attn_every, 1), 1)
        active += n_apps * shared
    elif cfg.family == "audio":
        per_dec = _attn_params(cfg) * 2 + _mlp_params(cfg) + norms  # self+cross
        per_enc = _attn_params(cfg) + _mlp_params(cfg) + norms
        total += cfg.n_layers * per_dec + cfg.encoder_layers * per_enc
        active += cfg.n_layers * per_dec + cfg.encoder_layers * per_enc
    return int(total), int(active)


def _mamba2_params(cfg: ModelConfig) -> int:
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    in_proj = cfg.d_model * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
    conv = cfg.ssm_conv * (di + 2 * ns)
    out_proj = di * cfg.d_model
    extras = nh * 3 + di  # A_log, D, dt_bias, gate-norm weight
    return in_proj + conv + out_proj + extras + cfg.d_model


def analytic_flops(cfg: ModelConfig, seq: int, batch: int,
                   mode: str = "train") -> float:
    """MODEL_FLOPS for one step: 6·N·D (train) / 2·N_active·D (inference)
    plus the attention O(S²) term; decode counts one new token per sequence
    attending over a cache of `seq`."""
    total, active = count_params(cfg)
    mult = 6.0 if mode == "train" else 2.0
    if mode == "decode":
        tokens = batch  # one token per sequence
        flops = 2.0 * active * tokens
        # attention over the cache
        attn_layers = _n_attn_applications(cfg)
        flops += tokens * attn_layers * 4.0 * cfg.n_heads * cfg.hd * seq
        return flops
    tokens = batch * seq
    flops = mult * active * tokens
    attn_layers = _n_attn_applications(cfg)
    flops += tokens * attn_layers * mult * 2.0 * cfg.n_heads * cfg.hd * seq * 0.5
    if cfg.family == "ssm" or cfg.family == "hybrid":
        # SSD scan term: per token per layer ~ 2·d_inner·ssm_state (state upd)
        flops += tokens * cfg.n_layers * mult * 2.0 * cfg.d_inner * cfg.ssm_state
    return flops


def _n_attn_applications(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe"):
        return cfg.n_layers
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0
        return cfg.n_layers + n_cross
    if cfg.family == "hybrid":
        return max(cfg.n_layers // max(cfg.shared_attn_every, 1), 1)
    if cfg.family == "audio":
        return cfg.n_layers * 2 + cfg.encoder_layers
    return 0  # pure ssm
