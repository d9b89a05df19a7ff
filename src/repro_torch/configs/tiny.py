"""Reduced same-family configs for CPU smoke tests.

Every assigned architecture has a ``tiny_<family-shape>`` counterpart that
keeps the *structure* (GQA ratios, window pattern, MoE top-k, sLSTM
interleave, meta tokens, enc-dec split) while shrinking width/depth/vocab
so one forward + train step runs in seconds on CPU. The full configs are
exercised only via the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations


from repro_torch.configs.base import ModelConfig, get_model_config

_TINY_COMMON = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=256)


def tiny_of(arch: str) -> ModelConfig:
    """Reduced config preserving the arch's structural family."""
    full = get_model_config(arch)
    kw = dict(
        name=f"tiny-{full.name}",
        family=full.family,
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 * full.num_kv_heads // max(full.num_heads, 1)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rope_theta=full.rope_theta,
        use_qk_norm=full.use_qk_norm,
        tie_embeddings=full.tie_embeddings,
        embed_scale=full.embed_scale,
        embeddings_in=full.embeddings_in,
        mrope_sections=(2, 3, 3) if full.mrope_sections else (),
        dtype="float32",
    )
    if full.attn_window:
        kw["attn_window"] = 8
    if full.global_every:
        kw["global_every"] = 2
    if full.family == "moe":
        kw.update(num_experts=full.num_experts // 16 or 4,
                  num_experts_per_tok=min(2, full.num_experts_per_tok),
                  moe_d_ff=64)
        kw["num_experts"] = max(kw["num_experts"], 4)
    if full.family == "hybrid":
        kw.update(ssm_state=4, ssm_conv_width=4, ssm_expand=2,
                  mamba_heads=4, num_meta_tokens=4, attn_window=8)
    if full.family == "ssm":
        kw.update(slstm_every=2, ssm_conv_width=4)
    if full.family == "encdec":
        kw.update(encoder_layers=2, num_layers=2, max_target_positions=16)
    return ModelConfig(**kw)
