"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

48L, d_model=1280, 16 heads, d_ff=5120, vocab=504 (cluster targets).
The conv waveform frontend is a STUB per the assignment: ``input_specs``
supplies precomputed frame embeddings (B, T, d_model). Bidirectional
attention (``causal=False``); no decode shapes (encoder-only).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=("global",),
    causal=False,
    rope_variant="none",
    ffn_variant="gelu",
    embeds_input=True,
)

REDUCED = ModelConfig(
    name="hubert-xlarge-reduced",
    family="audio",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=320,
    vocab_size=64,
    layer_pattern=("global",),
    causal=False,
    rope_variant="none",
    ffn_variant="gelu",
    embeds_input=True,
    chunk_len=32,
)
