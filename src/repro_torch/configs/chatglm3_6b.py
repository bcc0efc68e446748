"""ChatGLM3-6B — dense LM with 2d (half-dim) RoPE and extreme GQA
[arXiv:2406.12793].

28L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=65024.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="half",
)

REDUCED = ModelConfig(
    name="chatglm3-6b-reduced",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="half",
    chunk_len=32,
)
