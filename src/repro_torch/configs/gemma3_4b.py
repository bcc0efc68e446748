"""Gemma-3 4B — dense LM with 5:1 local:global attention
[hf:google/gemma-3-1b-pt family; unverified].

34L, d_model=2560, 8 heads (GQA kv=4), d_ff=10240, vocab=262144.
Locals use a 1024-token sliding window with θ=10k; every 6th layer is
global with θ=1M (the 128k-context recipe). GeGLU FFN, gemma-style
embedding scaling, QK-norm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10_240,
    vocab_size=262_144,
    layer_pattern=("local",) * 5 + ("global",),
    window=1024,
    rope_variant="full",
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    ffn_variant="geglu",
    scale_embed=True,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-4b-reduced",
    family="dense",
    n_layers=8,          # (5 local + 1 global) + 2 local remainder
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    layer_pattern=("local",) * 5 + ("global",),
    window=16,
    rope_variant="full",
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    ffn_variant="geglu",
    scale_embed=True,
    tie_embeddings=True,
    chunk_len=16,
)
