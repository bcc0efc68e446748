"""DeepSeekMoE-16B — fine-grained MoE [arXiv:2401.06066].

28L, d_model=2048, 16 heads, d_ff(expert)=1408, vocab=102400;
2 shared + 64 routed experts, top-6; first layer dense (d_ff=10944).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10_944,                 # the dense first layer's FFN width
    vocab_size=102_400,
    layer_pattern=("global",),
    first_k_dense=1,
    ffn_variant="swiglu",
    rope_variant="full",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408),
)

REDUCED = ModelConfig(
    name="deepseek-moe-16b-reduced",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=320,
    vocab_size=512,
    layer_pattern=("global",),
    first_k_dense=1,
    ffn_variant="swiglu",
    rope_variant="full",
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64),
    chunk_len=32,
)
