"""State carried across packages, as numpy arrays.

The fleet controller carries state: the fleet's cell parameters and vendor
index, a timing table (bin edges, ``(N, B, 2, 4)`` stack — or a rank-5
``(N, B, R, 2, 4)`` region stack — and refresh policy), a region sweep's
stacks, the controller registers, the score partials and a materialized
replay history. The LM serving path carries weights and per-layer caches:
KV caches, and the RG-LRU, mLSTM and sLSTM states.
The ``*_from_numpy`` functions take them as numpy arrays — as
``np.asarray`` gives them from the reference package's objects, which use
the same field names and layouts — and return this package's objects on a
device; the ``*_to_numpy`` functions go back, for comparisons.

The reference stacks LM layers as ``prefix`` (list) / ``groups`` (``pos{i}``
leaves stacked over the repeats of ``layer_pattern``) / ``suffix`` (list);
the port keeps one entry per layer. ``lm_*`` unstack and restack, on the
leading axis of every leaf whatever its rank: an expert layer's ``(E, d,
f)`` weights are ``(G, E, d, f)`` in a group, its float32 router ``(G, d,
E)``, its shared FFN a dictionary of matrices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.charge import CellParams
from repro_torch.core.controller import ControllerState, DimmTimingTable, ReplayResult
from repro_torch.core.fleet import Fleet, RegionSweepResult
from repro_torch.core.perfmodel import ScorePartials
from repro_torch.core.refresh import RefreshPolicy
from repro_torch.models.blocks import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.xlstm import MLSTMCache, MLSTMState, SLSTMState
from repro_torch.tree import tree_map


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def cells_from_numpy(r, c, leak, device="cuda") -> CellParams:
    return CellParams(*(_t(a, torch.float32, device) for a in (r, c, leak)))


def fleet_from_numpy(r, c, leak, vendor, device="cuda") -> Fleet:
    return Fleet(cells=cells_from_numpy(r, c, leak, device),
                 vendor=_t(vendor, torch.int32, device))


def table_from_numpy(temp_bins: Sequence[float], stack, device="cuda",
                     refresh: Optional[RefreshPolicy] = None) -> DimmTimingTable:
    """``refresh`` is a policy with the reference's field names (a
    ``RefreshPolicy`` of either package, or ``None``)."""
    if refresh is not None and not isinstance(refresh, RefreshPolicy):
        refresh = RefreshPolicy(tuple(refresh.boundaries), tuple(refresh.multipliers),
                                refresh.trefi_base_ns, refresh.trfc_ns)
    return DimmTimingTable(temp_bins=tuple(float(t) for t in temp_bins),
                           stack=_t(stack, torch.float32, device), refresh=refresh)


def region_sweep_from_numpy(temps_c, patterns, region_fracs, read, write,
                            temps_exact: Sequence[float] = (),
                            device="cuda") -> RegionSweepResult:
    """A region sweep's ``(T,)``, ``(P,)``, ``(R,)`` grids and ``(T, P, R, N,
    4)`` read / write stacks (the reference's ``RegionSweepResult`` fields)."""
    f32 = [_t(a, torch.float32, device)
           for a in (temps_c, patterns, region_fracs, read, write)]
    return RegionSweepResult(*f32, temps_exact=tuple(float(t) for t in temps_exact))


def state_from_numpy(bin_idx, cool_streak, fused, device="cuda") -> ControllerState:
    return ControllerState(_t(bin_idx, torch.int32, device),
                           _t(cool_streak, torch.int32, device),
                           _t(fused, torch.bool, device))


def partials_from_numpy(occupancy, switches, timing_sums, n_steps,
                        device="cuda") -> ScorePartials:
    return ScorePartials(_t(occupancy, torch.int32, device), _t(switches, torch.int32, device),
                         _t(timing_sums, torch.float32, device),
                         _t(n_steps, torch.int32, device))


def replay_from_numpy(timings, bin_idx, switched, fused, state, device="cuda") -> ReplayResult:
    """A replay history; ``state`` is ``(bin_idx, cool_streak, fused)``."""
    return ReplayResult(_t(timings, torch.float32, device), _t(bin_idx, torch.int32, device),
                        _t(switched, torch.bool, device), _t(fused, torch.bool, device),
                        state_from_numpy(*state, device=device))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def cells_to_numpy(cells: CellParams) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in cells._asdict().items()}


def fleet_to_numpy(fl: Fleet) -> Dict[str, np.ndarray]:
    """Cell parameters and the vendor index (what ``vendor_skew`` reads)."""
    return {**cells_to_numpy(fl.cells), "vendor": _np(fl.vendor)}


def table_to_numpy(table: DimmTimingTable) -> Dict[str, np.ndarray]:
    return {"temp_bins": np.asarray(table.temp_bins, np.float64),
            "stack": _np(table.stack)}


def region_sweep_to_numpy(res: RegionSweepResult) -> Dict[str, object]:
    """The sweep's fields by the reference's names (``temps_exact`` a tuple)."""
    out: Dict[str, object] = {k: _np(getattr(res, k))
                              for k in ("temps_c", "patterns", "region_fracs", "read", "write")}
    out["temps_exact"] = tuple(res.temps_exact)
    return out


def state_to_numpy(state: ControllerState) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in state._asdict().items()}


def partials_to_numpy(partials: ScorePartials) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in partials._asdict().items()}


def replay_to_numpy(res: ReplayResult) -> Dict[str, np.ndarray]:
    """History arrays plus the final state under ``state_*`` keys."""
    out = {k: _np(getattr(res, k)) for k in ("timings", "bin_idx", "switched", "fused")}
    out.update({f"state_{k}": v for k, v in state_to_numpy(res.state).items()})
    return out


# ---------------------------------------------------------------------------
# LM weights and KV caches
# ---------------------------------------------------------------------------
def _unstack(stack_tree, cfg: ModelConfig) -> List[Any]:
    """The reference's prefix / groups / suffix stack → one subtree per layer."""
    layers = list(stack_tree["prefix"])
    for g in range(cfg.n_groups):
        for p in range(cfg.pattern_len):
            layers.append(tree_map(lambda a, g=g: np.asarray(a)[g],
                                   stack_tree["groups"][f"pos{p}"]))
    return layers + list(stack_tree["suffix"])


def _restack(layers: List[Any], cfg: ModelConfig) -> Dict[str, Any]:
    """One subtree per layer → the reference's prefix / groups / suffix stack."""
    start = cfg.n_prefix + cfg.n_groups * cfg.pattern_len
    groups = {}
    for p in range(cfg.pattern_len):
        members = [layers[cfg.n_prefix + g * cfg.pattern_len + p] for g in range(cfg.n_groups)]
        if members:
            groups[f"pos{p}"] = tree_map(lambda *xs: np.stack(xs), *members)
    return {"prefix": layers[:cfg.n_prefix], "groups": groups, "suffix": layers[start:]}


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device="cuda") -> Dict[str, Any]:
    """The reference's LM parameters (``jax.tree.map(np.asarray, params)``)
    → the port's parameter dictionary on ``device``, dtypes kept."""
    layers = _unstack(tree["stack"], cfg)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, the config has {cfg.n_layers}")

    def to_t(a):
        return _tensor(a, device)

    out = {k: tree_map(to_t, tree[k]) for k in tree if k != "stack"}
    out["stack"] = [tree_map(to_t, layer) for layer in layers]
    return out


def lm_params_to_numpy(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters → the reference's tree of numpy arrays
    (bfloat16 leaves as float32, which holds them exactly)."""
    out = {k: tree_map(_np32, params[k]) for k in params if k != "stack"}
    out["stack"] = _restack([tree_map(_np32, layer) for layer in params["stack"]], cfg)
    return out


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, dtype kept; a bfloat16 array
    (the ``ml_dtypes`` type JAX gives) through its 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def _np32(x: torch.Tensor) -> np.ndarray:
    return _np(x.to(torch.float32) if x.dtype == torch.bfloat16 else x)


def opt_state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device="cuda") -> Dict[str, Any]:
    """The reference's optimizer state (``m``, ``v``: trees like the
    parameters, ``step``, and ``grad_err`` with gradient compression) →
    the port's, on ``device``: ``step`` a 0-d int32 tensor, dtypes kept."""
    out = {k: lm_params_from_numpy(tree[k], cfg, device)
           for k in ("m", "v", "grad_err") if k in tree}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=device)
    return out


def opt_state_to_numpy(state: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's optimizer state → the reference's tree of numpy arrays
    (bfloat16 leaves as float32)."""
    out = {k: lm_params_to_numpy(state[k], cfg) for k in ("m", "v", "grad_err") if k in state}
    out["step"] = np.asarray(int(state["step"]), dtype=np.int32)
    return out


#: The port's cache type of each token mixer; the reference's has the same
#: fields (``MLSTMCache.state`` an ``MLSTMState``).
_CACHE_TYPES = {"global": KVCache, "local": KVCache, "rglru": RGLRUCache,
                "mlstm": MLSTMCache, "slstm": SLSTMState}


def lm_cache_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda") -> List[Any]:
    """The reference's serving caches (a stack of per-layer caches — named
    tuples or dictionaries of numpy arrays with the reference's field names)
    → the port's per-layer list on ``device``: :class:`KVCache`,
    :class:`RGLRUCache`, :class:`MLSTMCache` or :class:`SLSTMState` by the
    layer's mixer. Values are copied as they are (the stabilizers' −inf
    included)."""
    def field(c, name):
        return getattr(c, name) if hasattr(c, "_fields") else c[name]

    def one(c, typ):
        if typ is MLSTMCache:
            return MLSTMCache(state=one(field(c, "state"), MLSTMState),
                              conv=torch.tensor(np.asarray(field(c, "conv")), device=device))
        return typ(*(torch.tensor(np.asarray(field(c, n)), device=device) for n in typ._fields))

    return [one(c, _CACHE_TYPES[cfg.mixer_of(i)])
            for i, c in enumerate(_unstack(tree, cfg))]


def lm_cache_to_numpy(caches: List[Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's per-layer caches → the reference's prefix / groups / suffix
    stack of named tuples (the port's types, the reference's field names)
    of numpy arrays."""
    return _restack([tree_map(_np, c) for c in caches], cfg)
