"""Model configuration: one declarative description of a language model.

The port's copy of the reference's ``ModelConfig`` and ``MoEConfig``
(``src/repro/models/config.py``), with the same fields and defaults, so a
config of either package describes the same model. A config fully
determines parameter shapes and the layer stack (``layer_pattern`` cycled
over depth). ``param_count`` counts from shapes, without allocating.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: Token-mixer kinds allowed in ``layer_pattern``.
MIXER_KINDS = ("global", "local", "mlstm", "slstm", "rglru")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int           # routed experts
    top_k: int
    n_shared: int = 0        # always-active shared experts
    d_ff_expert: int = 0     # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0                      # 0 → d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("global",)
    first_k_dense: int = 0               # prefix layers forced to dense FFN

    # attention
    causal: bool = True
    window: int = 0                      # sliding window for "local" mixers
    rope_variant: str = "full"           # full | half | mrope | none
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0       # gemma3: separate theta for globals
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False

    # channel mixer
    ffn_variant: str = "swiglu"          # swiglu | geglu | gelu | none
    moe: Optional[MoEConfig] = None

    # recurrent families
    conv_width: int = 4
    rglru_c: float = 8.0
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334
    chunk_len: int = 256                 # chunked attention's KV chunk
    attn_block_skip: bool = False
    # Attention backend: "chunked" (plain-torch online softmax over KV
    # chunks) or "pallas" (kernels/flash_attention: the CUDA kernel on a
    # card, its plain version on the CPU). The name is the reference's.
    attn_impl: str = "chunked"

    # embeddings / head
    scale_embed: bool = False            # gemma-style sqrt(d) scaling
    tie_embeddings: bool = False
    embeds_input: bool = False           # modality stub supplies embeddings

    norm_eps: float = 1e-6
    family: str = "dense"                # dense|moe|vlm|audio|ssm|hybrid

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError("GQA group must divide: n_heads % n_kv_heads != 0")
        for k in self.layer_pattern:
            if k not in MIXER_KINDS:
                raise ValueError(f"unknown mixer kind {k!r}")
        if self.moe is not None and self.moe.d_ff_expert <= 0:
            raise ValueError("MoEConfig.d_ff_expert must be positive")

    # ---- stacking geometry -------------------------------------------------
    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_prefix(self) -> int:
        return self.first_k_dense

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.n_prefix) // self.pattern_len

    @property
    def n_suffix(self) -> int:
        return (self.n_layers - self.n_prefix) % self.pattern_len

    def mixer_of(self, layer_idx: int) -> str:
        """Token mixer of an absolute layer index."""
        if layer_idx < self.n_prefix:
            return self.layer_pattern[0]
        return self.layer_pattern[(layer_idx - self.n_prefix) % self.pattern_len]

    def uses_moe(self, layer_idx: int) -> bool:
        return self.moe is not None and layer_idx >= self.first_k_dense

    # ---- analytics ---------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count from shapes."""
        from repro_torch.models import model as _model

        return _model.count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models import model as _model

        return _model.count_params_analytic(self, active_only=True)

    @property
    def has_recurrence(self) -> bool:
        return any(k in ("mlstm", "slstm", "rglru") for k in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True iff no unbounded-context attention layer exists."""
        return "global" not in self.layer_pattern
