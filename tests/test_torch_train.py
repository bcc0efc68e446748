"""The port's training path (``optim/``, ``data/``, ``models.model.lm_loss``,
``train/step.py``) vs the JAX reference, on the CPU.

The same numpy inputs and state go through the reference's functions and
the port's (state through ``convert``):

* ``schedule`` over warmup and cosine decay: within 1e-7 of the peak rate;
* ``apply_updates`` from a mid-run state (step 5, nonzero moments) at both
  ``state_dtype``\\ s: parameters and float32 moments within 1e-6 of each
  leaf's largest entry, bfloat16 moments within one bfloat16 ulp (1/128
  of the entry), the step and metrics equal;
* int8 compression with error feedback: bitwise;
* ``batch_for_step`` bitwise for tokens (smollm), embeddings (hubert) and
  M-RoPE positions (qwen2-vl), and ``_split_micro`` on them;
* ``lm_loss`` and its gradients in float32 for six reduced families (the
  float32 compute copies): loss within 1e-6 relative, every gradient leaf
  within 1e-5 of its largest entry (float32 sums in another order, and
  AdamW-free: these are the raw gradients). In bfloat16 the loss within
  ``STEP_TOL["bfloat16"]["loss"]`` = 1e-3 relative: the reference's XLA
  fusions keep some intermediate values in float32 where the port's eager
  ops round each to bfloat16 (``xla_allow_excess_precision``), and the
  port's fused activations round once where ``jax.nn``'s steps round each
  (``blocks.silu`` takes the reference's steps: deepseek-moe-16b's loss
  and step exceed their tolerances without them). The largest skipped
  rounding is the residual sum before ``ln2`` in ``stack.apply_layer``:
  XLA fuses the add into the norm, which reads the float32 sum where the
  port's norm reads its bfloat16 rounding. Torch can read the float32 sum
  too, but where XLA fuses depends on the graph: so changed, reduced
  chatglm3-6b's first layer became bitwise the reference's and its loss
  gap fell from 2.8e-4 to 3.4e-5 relative, while qwen2-vl-72b's rose from
  1.8e-5 to 1.2e-4, gemma3-4b's from 8.0e-5 to 1.2e-4 and llama3.2-3b's
  stayed 1.7e-4. So the port keeps the reference's source order and the
  tolerance stays ``STEP_TOL``;
* one full train step (reference's ``make_train_step`` under ``jax.jit``)
  for reduced smollm-135m and deepseek-moe-16b, smollm with gradient
  compression, and smollm and qwen2-vl (M-RoPE) in two microbatches, at
  float32 compute within ``STEP_TOL["float32"]`` (1e-5
  relative: loss, grad norm, the parameters, each leaf's first moment —
  the clipped gradient; the step's update 1e-3, AdamW's ε amplifying the
  gradients' float32 noise in entries near 0) and at bfloat16 within
  ``STEP_TOL["bfloat16"]`` (see ``launch/train.py``).

Port-only properties mirror ``tests/test_train.py``: microbatch
equivalence, the loss decreasing, the non-finite skip; and ``remat`` True,
False and ``"offload"`` give equal gradients; a config with
``attn_impl="pallas"`` is refused.

Every oracle is a ``jax.jit`` program, compiled once per shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import model as jlm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train import step as jstep
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.data import pipeline as tdata
from repro_torch.launch.train import STEP_TOL
from repro_torch.models import model as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.tree import leaves, tree_map
from repro_torch.train import step as tstep

FAMILIES = ("smollm-135m", "deepseek-moe-16b", "qwen2-vl-72b", "hubert-xlarge",
            "recurrentgemma-9b", "xlstm-125m")
BATCH, SEQ = 2, 32


def _ref_state(arch, tc=None):
    """The reference's params (and optimizer state) at seed 0 as numpy."""
    cfg = jconfigs.reduced(arch)
    if tc is None:
        return jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), cfg))
    p, o = jstep.init_train_state(jax.random.PRNGKey(0), cfg, tc)
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(arch, step=3, batch=BATCH, seq=SEQ):
    return jdata.batch_for_step(jconfigs.reduced(arch),
                                jdata.DataConfig(seq_len=seq, global_batch=batch), step)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------
def test_schedule_matches_reference():
    jcfg = jadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    tcfg = tadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: jadamw.schedule(jcfg, s))(steps))
    got = tadamw.schedule(tcfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * 1e-3)


def _opt_inputs(state_dtype):
    rng = np.random.default_rng(0)
    # Keys in sorted order: the order jax.tree.leaves visits them.
    params = {"stack": [{"scale": rng.standard_normal(24).astype(np.float32) * 0.01}],
              "w": rng.standard_normal((16, 24)).astype(np.float32) * 0.1}
    grads = tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    m = tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, params)
    v = tree_map(lambda p: rng.random(p.shape).astype(np.float32) * 0.01 + 1e-4, params)
    if state_dtype == "bfloat16":
        m, v = (jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), x)
                for x in (m, v))
    return params, grads, m, v


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    params, grads, m, v = _opt_inputs(state_dtype)
    kw = dict(peak_lr=1e-3, warmup_steps=3, total_steps=20, state_dtype=state_dtype)
    jcfg, tcfg = jadamw.OptConfig(**kw), tadamw.OptConfig(**kw)
    step = np.asarray(5, np.int32)
    jp, jst, jm = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, jcfg))(
        params, grads, {"m": m, "v": v, "step": step})
    to_t = lambda a: convert._tensor(a, "cpu")  # noqa: E731
    tp, tg = tree_map(to_t, params), tree_map(to_t, grads)
    tst = {"m": tree_map(to_t, m), "v": tree_map(to_t, v), "step": torch.tensor(5, dtype=torch.int32)}
    tp, tst, tm = tadamw.apply_updates(tp, tg, tst, tcfg)
    assert int(tst["step"]) == int(jst["step"]) == 6
    for k in ("grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    for want, got in zip(jax.tree.leaves(jp), leaves(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6 * np.abs(np.asarray(want)).max(), rtol=0)
    for key in ("m", "v"):
        for want, got in zip(jax.tree.leaves(jst[key]), leaves(tst[key])):
            want = np.asarray(want, np.float32)
            assert str(got.dtype) == f"torch.{state_dtype}"
            got = got.to(torch.float32).numpy()
            if state_dtype == "float32":
                np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
            else:  # one bfloat16 ulp: 2^-7 of the entry
                np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


def test_compress_matches_reference():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((32, 48)).astype(np.float32),
             "b": [rng.standard_normal(48).astype(np.float32) * 1e-3]}
    err = jax.tree.map(lambda a: np.asarray(jnp.asarray(a * 0.01).astype(jnp.bfloat16)), grads)
    jg, je = jax.jit(jcompress.compress_with_feedback)(grads, err)
    tg = tree_map(lambda a: torch.from_numpy(a.copy()), grads)
    te = tree_map(lambda a: convert._tensor(a, "cpu"), err)
    tcompress.compress_with_feedback(tg, te)
    for want, got in zip(jax.tree.leaves(jg), leaves(tg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for want, got in zip(jax.tree.leaves(je), leaves(te)):
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), np.asarray(want, np.float32))
    q, s = tcompress.quantize(torch.from_numpy(grads["a"]))
    jq, js = jcompress.quantize(jnp.asarray(grads["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge", "qwen2-vl-72b"])
def test_batch_for_step_bitwise(arch):
    dc_kw = dict(seq_len=24, global_batch=4, seed=3)
    for step in (0, 7):
        want = jdata.batch_for_step(jconfigs.reduced(arch), jdata.DataConfig(**dc_kw), step)
        got = tdata.batch_for_step(tconfigs.reduced(arch), tdata.DataConfig(**dc_kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    it = tdata.iterate(tconfigs.reduced(arch), tdata.DataConfig(**dc_kw), start_step=7)
    np.testing.assert_array_equal(next(it)["labels"], want["labels"])
    # Microbatches: the reference's split, M-RoPE positions on their batch axis.
    jmicro = jax.jit(lambda b: jstep._split_micro(b, 2))({k: jnp.asarray(v) for k, v in want.items()})
    tmicro = tstep._split_micro(_t(want), 2)
    for i, mb in enumerate(tmicro):
        for k, x in mb.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(jmicro[k][i]))


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------
def _compute_tree(tree, dtype, cfg):
    """The train step's compute copies: float32 matrices (by the reference's
    rank on its stacked tree) cast, leaves that require grad."""
    ranks = iter([r for r, _ in tstep.reference_leaves(tree, cfg)])

    def one(p):
        c = p.detach()
        if next(ranks) >= 2 and c.dtype == torch.float32:
            c = c.to(dtype)
        return c.requires_grad_(True)

    return tree_map(one, tree)


def _jloss(cfg, dtype):
    def f(p, b):
        cp = jax.tree.map(lambda x: x.astype(dtype) if x.dtype == jnp.float32 and x.ndim >= 2
                          else x, p)
        return jlm.lm_loss(cp, cfg, b)
    return f


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_match_reference(arch):
    jcfg, tcfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    params = _ref_state(arch)
    batch = _batch(arch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(_jloss(jcfg, jnp.float32), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _compute_tree(convert.lm_params_from_numpy(params, tcfg, "cpu"), torch.float32, tcfg)
    tl, tm = tlm.lm_loss(tp, tcfg, _t(batch))
    tleaves = list(leaves(tp))
    grads = torch.autograd.grad(tl, tleaves, allow_unused=True)
    it = iter([torch.zeros_like(c) if g is None else g for c, g in zip(tleaves, grads)])
    tg = convert.lm_params_to_numpy(tree_map(lambda _: next(it), tp), tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for k in ("ce", "aux", "z", "tokens"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-6, atol=1e-9)
    want, got = _flat(jg), _flat(tg)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(np.abs(w).max(), 1e-30), rtol=0,
                                   err_msg=k)



@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_bfloat16_matches_reference(arch):
    jcfg, tcfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    params = _ref_state(arch)
    batch = _batch(arch)
    jl, jm = jax.jit(_jloss(jcfg, jnp.bfloat16))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _compute_tree(convert.lm_params_from_numpy(params, tcfg, "cpu"), torch.bfloat16, tcfg)
    with torch.no_grad():
        tl, tm = tlm.lm_loss(tp, tcfg, _t(batch))
    tol = STEP_TOL["bfloat16"]["loss"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=tol)


# ---------------------------------------------------------------------------
# one full train step
# ---------------------------------------------------------------------------
STEP_CASES = [("smollm-135m", "float32", False, 1), ("deepseek-moe-16b", "float32", False, 1),
              ("smollm-135m", "bfloat16", False, 1), ("deepseek-moe-16b", "bfloat16", False, 1),
              ("smollm-135m", "float32", True, 1),
              # Two microbatches: the reference scans them and divides the
              # float32 sum by their number (qwen2-vl: M-RoPE positions).
              ("smollm-135m", "float32", False, 2), ("qwen2-vl-72b", "float32", False, 2)]


@pytest.mark.parametrize("arch,dtype,compress,micro", STEP_CASES)
def test_train_step_matches_reference(arch, dtype, compress, micro):
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jtc = jstep.TrainConfig(compute_dtype=dtype, compress_grads=compress, microbatches=micro,
                            opt=jadamw.OptConfig(**kw))
    ttc = tstep.TrainConfig(compute_dtype=dtype, compress_grads=compress, microbatches=micro,
                            opt=tadamw.OptConfig(**kw))
    jcfg, tcfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    params, opt = _ref_state(arch, jtc)
    tp = convert.lm_params_from_numpy(params, tcfg, "cpu")
    to = convert.opt_state_from_numpy(opt, tcfg, "cpu")
    batch = _batch(arch, step=0, batch=4)
    jp, jo, jm = jax.jit(jstep.make_train_step(jcfg, jtc))(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tm = tstep.make_train_step(tcfg, ttc)(tp, to, _t(batch))
    tol = STEP_TOL[dtype]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol[k], err_msg=k)
    np.testing.assert_allclose(float(tm["clip_scale"]), float(jm["clip_scale"]),
                               rtol=tol["grad_norm"])
    assert float(tm["lr"]) == float(jm["lr"]) and float(tm["skipped"]) == 0.0
    assert int(to["step"]) == int(jo["step"]) == 1
    want, got = _flat(jp), _flat(convert.lm_params_to_numpy(tp, tcfg))
    before = _flat(params)
    cat = lambda d: np.concatenate([d[k].ravel() for k in want]).astype(np.float64)  # noqa: E731
    dw, dg = cat(want) - cat(before), cat(got) - cat(before)
    assert np.linalg.norm(dg - dw) <= tol["update"] * np.linalg.norm(dw)
    want_m, got_m = _flat(jo["m"]), _flat(convert.lm_params_to_numpy(to["m"], tcfg))
    if dtype == "float32":
        assert np.linalg.norm(cat(got) - cat(want)) <= tol["params"] * np.linalg.norm(cat(want))
        for k, w in want_m.items():
            if not compress:
                assert np.linalg.norm(got_m[k] - w) <= tol["moments"] * np.linalg.norm(w), k
                continue
            # m is (1 - b1) times the dequantized gradient: an entry whose
            # gradient lies within float32 noise of a rounding boundary
            # takes the neighbouring int8 level, one quantum (max|m| / 127)
            # away; every other entry agrees to float32 rounding.
            quantum = np.abs(w).max() / 127
            off = np.abs(got_m[k] - w) > 1e-5 * np.abs(w).max()
            assert off.mean() <= 1e-3, (k, off.sum())
            assert np.abs(got_m[k] - w).max() <= quantum * 1.001, k
    if compress:
        # The error state (bfloat16) agrees to a bfloat16 ulp plus the
        # gradients' own difference (1e-5 of their largest, 127 quanta), but
        # where the gradient took the neighbouring int8 level (above): one
        # quantum, max|m| / (127 (1 - b1) clip_scale) in gradient units.
        want_e = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), jo["grad_err"]))
        got_e = _flat(convert.lm_params_to_numpy(to["grad_err"], tcfg))
        clip = float(jm["clip_scale"])
        for k, w in want_e.items():
            quantum = np.abs(want_m[k]).max() / (127 * 0.1 * clip)
            diff = np.abs(got_e[k] - w)
            off = diff > 2.0 ** -7 * np.abs(w) + 1e-5 * 127 * quantum
            assert off.mean() <= 1e-3, (k, off.sum())
            assert diff.max() <= quantum * (1 + 2.0 ** -7), k  # and its bf16 rounding


def test_opt_state_converts_both_ways():
    tc = jstep.TrainConfig(compress_grads=True,
                           opt=jadamw.OptConfig(state_dtype="bfloat16"))
    _, opt = _ref_state("deepseek-moe-16b", tc)
    cfg = tconfigs.reduced("deepseek-moe-16b")
    t = convert.opt_state_from_numpy(opt, cfg, "cpu")
    assert t["step"].dtype == torch.int32 and t["step"].dim() == 0
    assert all(x.dtype == torch.bfloat16 for x in leaves(t["m"]))
    back = convert.opt_state_to_numpy(t, cfg)
    for k in ("m", "v", "grad_err"):
        for a, b in zip(jax.tree.leaves(opt[k]), jax.tree.leaves(back[k])):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)


# ---------------------------------------------------------------------------
# port-only properties (tests/test_train.py's, and remat)
# ---------------------------------------------------------------------------
def _port_state(arch="smollm-135m", tc=None, seed=1):
    tc = tc or tstep.TrainConfig()
    return tstep.init_train_state(torch.Generator().manual_seed(seed), tconfigs.reduced(arch), tc)


def test_microbatch_equivalence():
    """microbatches=1 and 4 give (nearly) the same update: accumulation is a
    reorganization of the same sums."""
    cfg = tconfigs.reduced("smollm-135m")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 32), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (8, 32), generator=g, dtype=torch.int32)}
    results = []
    for micro in (1, 4):
        tc = tstep.TrainConfig(microbatches=micro, opt=tadamw.OptConfig(peak_lr=1e-3))
        params, opt = _port_state(tc=tc)
        params, opt, m = tstep.make_train_step(cfg, tc)(params, opt, batch)
        results.append((params, float(m["loss"]), float(m["grad_norm"])))
    (p1, l1, n1), (p4, l4, n4) = results
    assert abs(l1 - l4) < 5e-3
    # The gradient itself, before AdamW normalizes its scale away.
    assert abs(n1 - n4) <= 1e-2 * n1, (n1, n4)
    for a, b in zip(leaves(p1), leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=2e-5)


def test_loss_decreases():
    # float32 compute: bfloat16 products are slow on the CPU, and the
    # bfloat16 step is held to the reference above and trained on the card.
    cfg = tconfigs.reduced("smollm-135m")
    tc = tstep.TrainConfig(compute_dtype="float32",
                           opt=tadamw.OptConfig(peak_lr=2e-3, warmup_steps=5, total_steps=60))
    params, opt = _port_state(tc=tc, seed=0)
    step = tstep.make_train_step(cfg, tc)
    dc = tdata.DataConfig(seq_len=64, global_batch=8)
    losses = []
    for i in range(12):
        params, opt, m = step(params, opt, _t(tdata.batch_for_step(cfg, dc, i)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_nonfinite_grads_skip_update():
    cfg = tconfigs.reduced("smollm-135m")
    tc = tstep.TrainConfig()
    params, opt = _port_state(tc=tc, seed=0)
    params["embed"][0, 0] = float("nan")
    before = [t.clone() for t in leaves(params)]
    m_before = [t.clone() for t in leaves(opt["m"])]
    bad = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
           "labels": torch.zeros((2, 16), dtype=torch.int32)}
    params, opt, m = tstep.make_train_step(cfg, tc)(params, opt, bad)
    assert float(m["skipped"]) == 1.0 and int(opt["step"]) == 0
    for a, b in zip(leaves(params), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(leaves(opt["m"]), m_before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_remat_modes_give_equal_gradients(arch):
    cfg = tconfigs.reduced(arch)
    params, _ = _port_state(arch)
    batch = _t(_batch(arch))
    grads = {}
    for remat in (False, True, "offload"):
        cp = _compute_tree(params, torch.float32, cfg)
        from repro_torch.models import moe
        with moe.recording_routes() as routes:
            loss, _ = tlm.lm_loss(cp, cfg, batch, remat=remat)
            grads[remat] = torch.autograd.grad(loss, list(leaves(cp)))
        # Each routing is recorded once, also when the layer runs again for
        # its backward pass.
        assert len(routes) == sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    for remat in (True, "offload"):
        for a, b in zip(grads[remat], grads[False]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_pallas_attention_is_refused():
    """The flash-attention kernel has no backward pass (nor has the
    reference's Pallas kernel: ``jax.grad`` through it fails), so a config
    that routes attention through it cannot train."""
    cfg = dataclasses.replace(tconfigs.reduced("smollm-135m"), attn_impl="pallas")
    with pytest.raises(ValueError, match="no backward pass"):
        tstep.make_train_step(cfg, tstep.TrainConfig())
