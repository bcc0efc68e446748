"""Sharded training on four gloo ranks on the CPU: the port's DTensor step,
``train(mesh=)``, the elastic restore and the expert-parallel MoE branch,
against the one-rank port and the JAX reference.

One module-scoped :func:`shard.launch` of four ranks runs
``chip_smoke.sharded_train_parity`` (a rank body that imports no JAX) on
a (2, 2) ``("data", "model")`` mesh under ``DEFAULT_RULES`` (tensor
parallelism over ``model``, FSDP over ``data``, experts over ``model``):

* one float32 step of reduced smollm-135m (3 heads over ``model`` = 2: the
  heads are gathered before the split), deepseek-moe-16b (8 experts: the
  expert-parallel branch), qwen2-vl-72b (embeddings in, M-RoPE's (3, B,
  S) positions, 2 microbatches split on each rank's rows) and xlstm-125m
  (three mLSTM layers and an sLSTM layer, each run on its rank's rows and
  heads), cut to 1, 2, 1 and 4 layers, 4 × 16 tokens, against the one-rank step of the same
  state and batch within ``launch.train.STEP_TOL["float32"]`` (loss and
  grad norm 1e-5, parameters 1e-5, first moments 1e-5 a leaf, update
  1e-3; routings equal but at a near-tie, ``STEP_FLIP_EPS``). With
  experts the one-rank step runs under ``chip_smoke.data_shards(2)``: the
  expert-parallel branch's capacity and load-balance loss are each data
  shard's, the reference's ``shard_map`` semantics;
* ``train(mesh=)`` for 3 steps of reduced deepseek-moe-16b at the
  reference's default schedule and float32 compute
  (``chip_smoke.SHARDED_TRAIN_CONFIG``): ``make_policy`` takes it for a
  small model (data parallelism over both axes, no tensor or expert
  parallelism), so its MoE layer runs the global dispatch on every rank;
  the one-rank run's losses within ``STEP_TOL["float32"]["loss"]`` each;
* reduced smollm-135m's parameters saved under (2, 2) and restored under
  (4, 1) and (1, 4) (``restore(shardings=)``): bitwise, each leaf placed
  as the new mesh's policy says; the reference's own ``ckpt.restore``
  reads the same files and gets equal arrays;
* the error fuse of ``train(mesh=)`` (``chip_smoke.fuse_restore``): a
  non-finite step while rank 0's asynchronous checkpoint write is pending
  and slowed; every rank restores the same, latest step, bitwise its
  files. A train step under the policy given a plain batch leaf raises
  (``chip_smoke.escaped_leaf``);
* reduced deepseek-moe-16b's MoE layer on inputs whose routing crowds one
  expert, so that a data shard's capacity (8 slots from its 16 tokens)
  binds where the global capacity (16 from 32) would keep other tokens:
  its output and aux loss against the reference's ``shard_map`` branch on
  four XLA host devices (a subprocess, as ``tests/test_elastic.py``) within
  1e-5, and each (data shard, model rank)'s kept assignments — the port's
  dispatch tables against the reference's routing under its capacity rule
  — identical.

Where the model code meets what DTensor does not support, the port keeps
the reference's semantics so:

* ``blocks._qkv`` and the attention output: a head split (or merge) that
  does not divide the ``model`` axis (smollm's 3 heads over 2) replicates
  that dimension first, in the forward and the backward pass
  (``parallel.sharding.reshape``), as GSPMD pads an uneven split;
* ``model.lm_loss``: a DTensor ``gather`` along the sharded vocabulary
  fails, so DTensor logits take the reference's masked sum;
* ``moe.moe_forward``: sort, top-k, the table writes (``index_put_``),
  gathers and ``index_add_`` run on local tensors inside ``local_map``
  (DTensor refuses a plain index tensor beside a DTensor operand); a
  policy without expert parallelism gathers the layer whole on every rank;
* ``train.step``: gradients come back partial or strided and are placed
  as their parameters; ``optim.adamw`` steps local shards and sums the
  global norm once over the ranks; microbatches split each rank's rows;
* ``xlstm``: the mLSTM's chunked form (its masks, the forget gates'
  ``log_sigmoid``, whose backward DTensor has no rule for) and the sLSTM's
  loop run on each rank's local rows and heads inside ``local_map``;
* ``stack``'s per-layer recompute runs under the forward's policy (the
  backward pass may run on another thread).
"""

import concurrent.futures
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch.configs as C
from repro_torch.core import shard
from repro_torch.launch import train as lm_train
from repro_torch.models import moe
from repro_torch.train.step import TrainConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
#: (arch, microbatches, layers): deepseek-moe-16b's second layer is its first
#: MoE layer.
CASES = (("smollm-135m", 1, 1), ("deepseek-moe-16b", 1, 2), ("qwen2-vl-72b", 2, 1),
         ("xlstm-125m", 1, 4))
BATCH, SEQ = 4, 16
TRAIN_CASE = ("deepseek-moe-16b", 3, 2)
EP_TOL = 1e-5
#: The MoE input: (B, S) and the weight of the direction that crowds one
#: expert.
EP_SHAPE, EP_CROWD = (4, 8), 3.0


def _ep_inputs():
    """Reduced deepseek-moe-16b's MoE layer (port draws) and an input whose
    tokens all lean towards expert 0."""
    cfg = C.reduced("deepseek-moe-16b")
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(gen, cfg)
    b, s = EP_SHAPE
    x = torch.randn((b, s, cfg.d_model), generator=gen) * 0.3
    u = p["router"][:, 0] / p["router"][:, 0].norm()
    x = x + EP_CROWD * u
    tree = {k: (v.numpy() if not isinstance(v, dict) else {kk: vv.numpy() for kk, vv in v.items()})
            for k, v in p.items()}
    return {"params": tree, "x": x.numpy()}


def _reference_ep(ep, tmp):
    """The reference's ``moe_forward`` under a (2, 2) policy on four XLA host
    devices, and its routing of each data shard's tokens."""
    inp = tmp / "ep_in.npz"
    flat = {f"p/{k}": v for k, v in ep["params"].items() if not isinstance(v, dict)}
    flat.update({f"s/{k}": v for k, v in ep["params"]["shared"].items()})
    np.savez(inp, x=ep["x"], **flat)
    out = tmp / "ep_out.npz"
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax, jax.numpy as jnp, numpy as np
        import repro.configs as C
        from repro.launch.mesh import auto_mesh
        from repro.models import moe
        from repro.parallel.sharding import DEFAULT_RULES, ShardingPolicy, use_policy

        cfg = C.reduced("deepseek-moe-16b")
        d = np.load(r"{inp}")
        p = {{k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("p/")}}
        p["shared"] = {{k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("s/")}}
        x = jnp.asarray(d["x"])
        pol = ShardingPolicy(auto_mesh((2, 2), ("data", "model")), dict(DEFAULT_RULES))
        with use_policy(pol):
            y, aux = jax.jit(lambda p, x: moe.moe_forward(p, x, cfg))(p, x)
        half = x.shape[0] // 2
        idx = [np.asarray(moe.route(p, x[i * half:(i + 1) * half].reshape(-1, x.shape[-1]),
                                    cfg)[1]) for i in range(2)]
        np.savez(r"{out}", y=np.asarray(y), aux=np.asarray(aux), idx0=idx[0], idx1=idx[1])
        print("EP_OK")
    """)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "EP_OK" in run.stdout, run.stdout[-1500:] + run.stderr[-3000:]
    d = np.load(out)
    return {"y": d["y"], "aux": float(d["aux"]), "idx": [d["idx0"], d["idx1"]]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks, reference)``: rank 0's ``sharded_train_parity`` results and
    the reference's expert-parallel forward, computed at the same time."""
    tmp = tmp_path_factory.mktemp("sharded")
    ep = _ep_inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(shard.launch, chip_smoke.sharded_train_parity, RANKS, "cpu", "cpu",
                            CASES, BATCH, SEQ, TRAIN_CASE, str(tmp / "ckpt"), ep,
                            str(tmp / "fuse"))
        reference = _reference_ep(ep, tmp)
        return ranks.result(), reference, ep, tmp / "ckpt"


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_sharded_step_matches_one_rank(ranks, arch):
    r = ranks["compare"][arch]
    assert r["mesh"] == [2, 2] and r["batch_groups"] == 2
    assert r["compared"] and r["route_flips"] == 0, r
    assert lm_train.within_tolerance(r, "float32"), r
    if arch == "deepseek-moe-16b":
        assert r["moe_calls"] == 2 * 1  # one MoE layer of the two, in two data shards


def test_train_with_a_mesh_gives_the_one_rank_losses(ranks):
    arch, steps, layers = TRAIN_CASE
    one = lm_train.train(arch, steps=steps, batch=BATCH, seq=SEQ, device="cpu",
                         n_layers=layers, log_every=steps,
                         train_config=TrainConfig(**chip_smoke.SHARDED_TRAIN_CONFIG))[2]
    got = ranks["train"]
    assert len(got) == len(one) == steps
    tol = lm_train.STEP_TOL["float32"]["loss"]
    for a, b in zip(got, one):
        assert abs(a - b) <= tol * abs(b), (got, one)


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_elastic_restore_across_meshes_is_bitwise(ranks, shape):
    r = ranks["elastic"][shape]
    assert r["step"] == 1 and r["leaves"] > 0
    assert r["mismatches"] == 0 and r["wrong_placements"] == 0, r


def test_error_fuse_restores_one_step_on_every_rank(ranks):
    """The error fuse under a mesh, with rank 0's asynchronous write of the
    latest checkpoint still pending and slowed: every rank restores that
    step (the one rank 0 waited for), and the gathered parameters are its
    files bitwise — no rank reads an older checkpoint or none."""
    r = ranks["fuse"]
    at = chip_smoke.FUSE_STEP
    assert r["skipped"] == [at]
    assert r["restored_by_rank"] == [[(at, 0)]] * RANKS, r
    losses = r["losses_by_rank"]
    assert all(x == losses[0] for x in losses) and len(losses[0]) == chip_smoke.FUSE_STEPS - 1
    assert all(np.isfinite(losses[0]))


def test_a_plain_leaf_under_a_policy_raises(ranks):
    assert "batch/" in ranks["escaped"] and "escaped placement" in ranks["escaped"]


def test_reference_restore_reads_the_ports_sharded_checkpoint(runs):
    from repro.ft import checkpoint as jckpt

    ranks, _, _, ckpt_dir = runs
    want = ranks["params"]
    # The port's tree shape, as the reference flattens it (list indices).
    tree = {}
    for path, arr in want.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def listify(t):
        if isinstance(t, dict) and t and all(k.isdigit() for k in t):
            return [listify(t[str(i)]) for i in range(len(t))]
        return {k: listify(v) for k, v in t.items()} if isinstance(t, dict) else t

    like = {"params": listify(tree)}
    got, step = jckpt.restore(ckpt_dir, like)
    assert step == 1
    import jax

    flat = jax.tree_util.tree_flatten_with_path(got["params"])[0]
    assert len(flat) == len(want)
    for path, arr in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        np.testing.assert_array_equal(np.asarray(arr), want[name])


def test_expert_parallel_matches_the_references_shard_map(runs):
    ranks, ref, _, _ = runs
    got = ranks["ep"]
    assert got["expert_parallel"]
    np.testing.assert_allclose(got["y"], ref["y"], rtol=0, atol=EP_TOL)
    assert abs(got["aux"] - ref["aux"]) <= EP_TOL
    # One device: the same semantics under data_shards(2); the global
    # dispatch (one capacity over all 32 tokens) differs, so the shards'
    # own capacity shows in the result.
    cfg = C.reduced("deepseek-moe-16b")
    p = {k: (torch.from_numpy(v) if not isinstance(v, dict)
             else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in runs[2]["params"].items()}
    x = torch.from_numpy(runs[2]["x"])
    with torch.no_grad(), chip_smoke.data_shards(2):
        y1, aux1 = moe.moe_forward(p, x, cfg)
    np.testing.assert_allclose(y1.numpy(), ref["y"], rtol=0, atol=EP_TOL)
    assert abs(float(aux1) - ref["aux"]) <= EP_TOL
    with torch.no_grad():
        y_global, _ = moe.moe_forward(p, x, cfg)
    assert np.abs(y_global.numpy() - ref["y"]).max() > 100 * EP_TOL


def _kept(e_of_slot, tok_of_slot, w_of_slot):
    return {(int(e), int(t)) for e, t, w in zip(e_of_slot, tok_of_slot, w_of_slot) if w > 0}


def test_expert_parallel_drops_match_the_reference(runs):
    """Each (data shard, model rank)'s kept (expert, token) assignments: the
    port's tables (the functions the branch runs on each rank) against the
    reference's routing under its capacity rule — the first ``cap`` of each
    expert's assignments in token order, ``cap`` from the shard's own
    tokens."""
    _, ref, ep, _ = runs
    cfg = C.reduced("deepseek-moe-16b")
    mo = cfg.moe
    x = torch.from_numpy(ep["x"])
    router = torch.from_numpy(ep["params"]["router"])
    half, e_loc = x.shape[0] // 2, mo.n_experts // 2
    dropped_any = False
    for s in range(2):
        xs = x[s * half:(s + 1) * half].reshape(-1, cfg.d_model)
        t = xs.shape[0]
        cap = max(moe._round_up(int(t * mo.top_k / mo.n_experts * mo.capacity_factor), 8), 8)
        w, idx, _, _ = moe._route(router, xs, mo)
        ridx = ref["idx"][s]
        np.testing.assert_array_equal(idx.numpy(), ridx)
        for m in range(2):
            lo = m * e_loc
            rel = idx - lo
            in_range = (rel >= 0) & (rel < e_loc)
            e_flat = torch.where(in_range, rel, e_loc).reshape(-1)
            tok_flat = torch.arange(t * mo.top_k) // mo.top_k
            w_flat = torch.where(in_range, w, 0.0).reshape(-1)
            tok_t, w_t = moe._tables(e_flat, tok_flat, w_flat, e_loc, cap)
            got = _kept(np.repeat(np.arange(e_loc), cap) + lo, tok_t.reshape(-1).numpy(),
                        w_t.reshape(-1).numpy())
            want, seen = set(), {}
            for tok in range(t):  # token order, then k order: the stable sort's
                for e in ridx[tok]:
                    if lo <= e < lo + e_loc:
                        seen[e] = seen.get(e, 0) + 1
                        if seen[e] <= cap:
                            want.add((int(e), tok))
            assert got == want, (s, m)
            dropped_any |= any(n > cap for n in seen.values())
    # The crowded expert overflows a shard's capacity.
    assert dropped_any
