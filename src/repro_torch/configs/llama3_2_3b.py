"""Llama-3.2 3B — small llama3 dense LM [hf:meta-llama/Llama-3.2-1B family;
unverified].

28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="full",
    rope_theta=500_000.0,
)

REDUCED = ModelConfig(
    name="llama3.2-3b-reduced",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=320,
    vocab_size=512,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="full",
    rope_theta=500_000.0,
    chunk_len=32,
)
