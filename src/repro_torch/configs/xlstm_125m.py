"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L, d_model=768, 4 heads, d_ff=0 (blocks own their projections),
vocab=50304. Pattern: 3 mLSTM : 1 sLSTM. Fully recurrent → runs the
long_500k cell (O(1) state decode).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ffn_variant="none",
    rope_variant="none",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="xlstm-125m-reduced",
    family="ssm",
    n_layers=4,
    d_model=96,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ffn_variant="none",
    rope_variant="none",
    tie_embeddings=True,
    chunk_len=16,
)
