"""RecurrentGemma-9B — RG-LRU + local attention hybrid, 2:1
[arXiv:2402.19427].

38L, d_model=4096, 16 heads (MQA kv=1 on attention layers), d_ff=12288,
vocab=256000. Pattern (rec, rec, local)×12 + (rec, rec); local window
2048. Bounded state → runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    ffn_variant="geglu",
    rope_variant="full",
    scale_embed=True,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-reduced",
    family="hybrid",
    n_layers=5,          # (rec, rec, local) + (rec, rec)
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    d_ff=320,
    vocab_size=512,
    layer_pattern=("rglru", "rglru", "local"),
    window=16,
    ffn_variant="geglu",
    rope_variant="full",
    scale_embed=True,
    tie_embeddings=True,
    chunk_len=16,
)
