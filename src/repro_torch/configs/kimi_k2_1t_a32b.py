"""Kimi K2 — trillion-parameter MoE, 32B active [arXiv:2501.kimi2
paper-table; unverified].

61L, d_model=7168, 64 heads (GQA kv=8), d_ff(expert)=2048, vocab=163840;
384 routed experts top-8 + 1 shared. The reference's launch policy trains
and serves it with bf16 parameters; the port's serving path draws float32
weights (on one card: the dense first layer and one MoE layer).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18_432,                 # dense first layer (DeepSeek-V3-style)
    vocab_size=163_840,
    layer_pattern=("global",),
    first_k_dense=1,
    ffn_variant="swiglu",
    rope_variant="full",
    rope_theta=50_000.0,
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, d_ff_expert=2048,
                  capacity_factor=1.1),
)

REDUCED = ModelConfig(
    name="kimi-k2-reduced",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    layer_pattern=("global",),
    first_k_dense=1,
    ffn_variant="swiglu",
    rope_variant="full",
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=1, d_ff_expert=64,
                  capacity_factor=1.1),
    chunk_len=32,
)
