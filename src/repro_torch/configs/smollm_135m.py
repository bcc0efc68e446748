"""SmolLM-135M — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M].

30L, d_model=576, 9 heads (GQA kv=3), d_ff=1536, vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49_152,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="full",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="smollm-135m-reduced",
    family="dense",
    n_layers=4,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    layer_pattern=("global",),
    ffn_variant="swiglu",
    rope_variant="full",
    tie_embeddings=True,
    chunk_len=32,
)
