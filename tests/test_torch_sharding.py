"""The port's sharding layer (``repro_torch.parallel``, ``launch/mesh.py``,
``models.model.logical_specs`` / ``cache_logical_specs``,
``data.pipeline.input_specs``) against the JAX reference, on the CPU and
without a process group.

* Logical specs: every parameter leaf of each of the ten reduced configs,
  and every cache leaf of gemma3-4b, xlstm-125m and recurrentgemma-9b,
  has the reference's spec of the same leaf (a grouped leaf's spec less
  its leading stacked-axis ``None``; ``train.step.reference_leaves`` tells
  which leaves the reference stacks). Exact equality.
* ``physical``, ``dividable`` and ``param_specs`` on the production 16 ×
  16 and 2 × 16 × 16 meshes and a 1-device mesh: the reference's on
  ``jax.sharding.AbstractMesh`` (no devices), the port's on
  ``MeshShape``. Exact equality of the partition specs.
* ``make_policy`` for every full config × train / prefill / decode ×
  single and multi-pod: rules, notes and every ``TrainConfig`` field equal.
* ``input_specs``: the reference's shapes and dtypes.
* ``constrain`` returns its argument itself without a policy and refuses
  a plain tensor under one; the DTensor placements of a spec.
* The MoE layer against an explicit per-token expert loop (capacity
  ample), the mirror of the reference's
  ``test_moe_matches_bruteforce_reference``: rtol 2e-4, atol 2e-5, as
  there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as JC
import repro_torch.configs as C
from repro.data import pipeline as jpipeline
from repro.models import model as jlm
from repro.parallel import policies as jpolicies
from repro.parallel import sharding as jsharding
from repro_torch.data import pipeline
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.parallel import policies, sharding
from repro_torch.train.step import reference_leaves
from repro_torch.tree import leaves, walk

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1": ((1,), ("model",))}
KINDS = ("train", "prefill", "decode")


def _is_spec(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def _ref_leaf(tree, path):
    for k in path:
        tree = getattr(tree, k) if isinstance(k, str) and hasattr(tree, "_fields") else tree[k]
    return tree


def _ref_path(path, rank, ndim, cfg):
    """The reference's path of the port's leaf ``path``, and whether it is
    stacked there (``reference_leaves``' rank one above the leaf's)."""
    if path[0] != "stack":
        return path, False
    i, rest = path[1], path[2:]
    start, stop = cfg.n_prefix, cfg.n_prefix + cfg.n_groups * cfg.pattern_len
    if rank == ndim + 1:
        return ("stack", "groups", f"pos{(i - start) % cfg.pattern_len}") + rest, True
    if i < start:
        return ("stack", "prefix", i) + rest, False
    return ("stack", "suffix", i - stop) + rest, False


def _named(tree, path=()):
    """(path, leaf) with a named tuple's field names (the reference's
    caches are named tuples with the same fields)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        for k, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from _named(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_logical_specs_equal_the_references(arch):
    cfg = C.reduced(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    specs = lm.logical_specs(params, cfg)
    jcfg = JC.reduced(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    jspecs = jlm.logical_specs(shapes, jcfg)
    got = list(_named(specs))
    assert len(got) == len(list(leaves(params)))
    seen = set()
    for (path, spec), (rank, _), p in zip(got, reference_leaves(params, cfg), leaves(params)):
        assert _is_spec(spec) and len(spec) == p.dim(), (path, spec, tuple(p.shape))
        rpath, stacked = _ref_path(path, rank, p.dim(), cfg)
        want = _ref_leaf(jspecs, rpath)
        assert (want[1:] if stacked else want) == spec, (path, spec, want)
        assert want[0] is None or not stacked
        seen.add(rpath)
    assert len(seen) == len(jax.tree.leaves(shapes))  # every reference leaf


@pytest.mark.parametrize("arch", ["gemma3-4b", "xlstm-125m", "recurrentgemma-9b"])
def test_cache_logical_specs_equal_the_references(arch):
    cfg = C.reduced(arch)
    caches = lm.init_cache(cfg, 2, 32, torch.float32)
    specs = lm.cache_logical_specs(caches, cfg)
    jcfg = JC.reduced(arch)
    shapes = jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, 32, jnp.float32))
    jspecs = jlm.cache_logical_specs(shapes, jcfg)
    start, stop = cfg.n_prefix, cfg.n_prefix + cfg.n_groups * cfg.pattern_len
    seen = set()
    for (path, spec), (_, t) in zip(_named(specs), _named(caches)):
        assert _is_spec(spec) and len(spec) == t.dim(), (path, spec)
        i, rest = path[0], path[1:]
        if start <= i < stop:
            rpath = ("groups", f"pos{(i - start) % cfg.pattern_len}") + rest
            want = _ref_leaf(jspecs, rpath)
            assert want[0] is None and want[1:] == spec, (path, spec, want)
        else:
            rpath = (("prefix", i) if i < start else ("suffix", i - stop)) + rest
            assert _ref_leaf(jspecs, rpath) == spec, (path, spec)
        seen.add(rpath)
    assert len(seen) == len(jax.tree.leaves(shapes))


def _policies(name):
    shape, axes = MESHES[name]
    rules = dict(sharding.DEFAULT_RULES)
    return (sharding.ShardingPolicy(sharding.MeshShape(axes, shape), rules),
            jsharding.ShardingPolicy(AbstractMesh(shape, axes), dict(jsharding.DEFAULT_RULES)))


SPECS = (("batch", None, None), (None, "batch", None), ("batch", "seq", "heads"),
         ("fsdp", "heads"), ("heads", "fsdp"), ("vocab", "fsdp"), ("experts", "fsdp", None),
         ("batch", None, "kv_heads", "head_dim"), ("batch", "heads", None, None),
         ("fsdp", "fsdp"), ("expert_cap", "batch"), (None,), ("unknown", "state"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_physical_and_dividable_equal_the_references(mesh):
    pol, jpol = _policies(mesh)
    for spec in SPECS:
        assert pol.physical(spec) == tuple(jpol.physical(spec)), spec
    for name in (None,) + tuple(sharding.DEFAULT_RULES) + ("unknown",):
        for dim in (1, 2, 3, 8, 16, 24, 256, 512, 768):
            assert pol.dividable(dim, name) == jpol.dividable(dim, name), (name, dim)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b", "recurrentgemma-9b"])
def test_param_specs_equal_the_references(arch, mesh):
    pol, jpol = _policies(mesh)
    cfg = C.reduced(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    placed = sharding.param_specs(lm.logical_specs(params, cfg), params, pol)
    jcfg = JC.reduced(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    jplaced = jsharding.param_specs(jlm.logical_specs(shapes, jcfg), shapes, jpol)
    for (path, pl), (rank, _), p in zip(_named(placed), reference_leaves(params, cfg),
                                        leaves(params)):
        rpath, stacked = _ref_path(path, rank, p.dim(), cfg)
        want = tuple(_ref_leaf(jplaced, rpath).spec)
        got = pol.physical(pl.spec)
        assert (want[1:] if stacked else want) == got, (path, got, want)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_make_policy_equals_the_references(arch, multi_pod, monkeypatch):
    # The reference counts parameters by tracing its init (seconds for the
    # largest configs, on every call); the port's analytic count is held
    # equal to it at full size in test_torch_lm_families.py and
    # test_torch_moe.py, so the reference's config reads that count here.
    count = C.get(arch).param_count()
    monkeypatch.setattr(type(JC.get(arch)), "param_count", lambda self: count)
    shape, axes = MESHES["2x16x16" if multi_pod else "16x16"]
    for kind in KINDS:
        for seq, batch in ((4096, 256), (32768, 8), (2048, 2)):
            got = policies.make_policy(sharding.MeshShape(axes, shape), C.get(arch), kind,
                                       seq, batch)
            want = jpolicies.make_policy(AbstractMesh(shape, axes), JC.get(arch), kind,
                                         seq, batch)
            assert got.sharding.rules == want.sharding.rules, (kind, seq)
            assert got.notes == want.notes, (kind, seq)
            assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train), (kind, seq)


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_equal_the_references(arch):
    for kind in KINDS:
        got = pipeline.input_specs(C.get(arch), 4096, 256, kind)
        want = jpipeline.input_specs(JC.get(arch), 4096, 256, kind)
        assert sorted(got) == sorted(want), kind
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (kind, k)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), (kind, k)


def test_constrain_noop_without_policy_and_refuses_plain_tensors_under_one():
    x = torch.ones((4, 4))
    assert sharding.constrain(x, ("batch", None)) is x
    pol, _ = _policies("16x16")
    with sharding.use_policy(pol):
        assert sharding.current_policy() is pol
        with pytest.raises(TypeError, match="escaped placement"):
            sharding.constrain(x, ("batch", None))
    assert sharding.current_policy() is None


def test_plain_values_enter_only_by_replicated_like():
    """``replicated_like`` gives a plain tensor back beside a plain one (it
    wraps only beside a DTensor); ``require_placed`` names the first plain
    leaf of a tree."""
    x, t = torch.ones((2, 3)), torch.zeros(3)
    assert sharding.replicated_like(t, x) is t
    sharding.require_placed({"a": [1.0, "meta"]}, "tree")  # no tensor: nothing to place
    with pytest.raises(TypeError, match=r"batch/labels: a plain tensor of shape \(2, 3\)"):
        sharding.require_placed({"labels": x}, "batch")


def test_init_params_places_part_by_part_with_the_same_draws():
    """``init_params(place=)`` hands each part over as it is drawn (the
    embedding, each layer, the final norm, the head) and keeps what
    ``place`` returns; the draws are those without it."""
    cfg = C.reduced("llama3.2-3b")
    parts = []

    def place(part):
        parts.append(sorted(part) if "embed" in part or "ln_f" in part or "head" in part
                     else "layer")
        return {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in part.items()}

    got = lm.init_params(torch.Generator().manual_seed(0), cfg, place=place)
    want = lm.init_params(torch.Generator().manual_seed(0), cfg)
    head = [] if cfg.tie_embeddings else [["head"]]
    assert parts == [["embed"]] + ["layer"] * cfg.n_layers + [["ln_f"]] + head
    assert list(got) == list(want)
    pairs = list(zip(walk(got), walk(want)))
    assert len(pairs) == len(list(walk(want)))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and torch.equal(a, b)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    pol, _ = _policies("2x16x16")
    assert pol.placements(("batch", None, "heads")) == (Shard(0), Shard(0), Shard(2))
    assert pol.placements(("fsdp", None)) == (Replicate(), Shard(0), Replicate())
    assert pol.fit((8, 24), ("batch", "heads")) == (None, None)
    assert pol.fit((64, 32), ("batch", "heads")) == ("batch", "heads")
    out_of_order = sharding.ShardingPolicy(pol.mesh, {"batch": ("data", "pod")})
    with pytest.raises(ValueError, match="order"):
        out_of_order.placements(("batch",))


def test_mesh_builders_refuse_without_a_process_group():
    from repro_torch.launch import mesh

    with pytest.raises(ValueError, match="256 ranks"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="no torch.distributed process group"):
        mesh.fleet_mesh(device="cpu")


def test_moe_matches_bruteforce_reference():
    """Capacity-ample MoE output == explicit per-token expert loop."""
    cfg = C.reduced("deepseek-moe-16b")
    mo = cfg.moe
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg)
    b, s = 2, 8
    x = torch.randn((b, s, cfg.d_model), generator=gen) * 0.3
    out, _ = moe.moe_forward(p, x, cfg)

    xf = x.reshape(-1, cfg.d_model)
    w, idx, _ = moe.route(p, xf, cfg)
    ref = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(mo.top_k):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(xf[t] @ p["w_gate"][e]) * (xf[t] @ p["w_up"][e])
            ref[t] += w[t, j] * (h @ p["w_down"][e])
    from repro_torch.models import blocks

    ref = ref.reshape(b, s, cfg.d_model) + blocks.ffn_forward(p["shared"], x, cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)


def test_port_imports_no_jax():
    import os
    import pathlib
    import subprocess
    import sys

    code = ("import sys; import repro_torch.parallel, repro_torch.parallel.policies, "
            "repro_torch.launch.mesh, repro_torch.launch.train, repro_torch.ft.checkpoint, "
            "repro_torch.data.pipeline, repro_torch.models.moe; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'repro'}; "
            "import torch.distributed as d; "
            "assert not bad, bad; assert not d.is_initialized(); print('OK')")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.strip() == "OK", out.stderr[-2000:]


def test_walk_of_placed_tree_matches_params():
    """``param_specs`` keeps the tree's structure (every leaf a Placed)."""
    cfg = C.reduced("deepseek-moe-16b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    pol, _ = _policies("16x16")
    placed = sharding.param_specs(lm.logical_specs(params, cfg), params, pol)
    assert [p for p, _ in walk(placed)] == [p for p, _ in walk(params)]
    assert all(isinstance(x, sharding.Placed) for x in leaves(placed))
