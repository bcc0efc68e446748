"""Qwen2-VL 72B — VLM transformer backbone with M-RoPE
[arXiv:2409.12191].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
The vision frontend (dynamic-resolution ViT) is a STUB per the assignment:
``input_specs`` supplies precomputed patch embeddings (B, S, d_model) and
the three M-RoPE position streams (temporal/height/width).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    embeds_input=True,
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced",
    family="vlm",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=320,
    vocab_size=512,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="mrope",
    mrope_sections=(4, 6, 6),
    embeds_input=True,
    chunk_len=32,
)
