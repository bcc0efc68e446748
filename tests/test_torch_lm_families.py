"""The port's LM families without experts vs the JAX reference, on the CPU.

Reduced gemma3-4b (local/global layers, qk-norm, GeGLU, a global theta),
chatglm3-6b (half RoPE, GQA 2), qwen2-vl-72b (embedding inputs and M-RoPE's
three position streams), recurrentgemma-9b (RG-LRU and a local layer) and
xlstm-125m (mLSTM and sLSTM), and hubert-xlarge (encoder-only) as the
reference's configs give them. Weights in the reference's parameter tree
(its shapes, values made with numpy from a seed) go into the reference as
they are and into the port through ``convert.lm_params_from_numpy``; the
same numpy prompts (ids, or embeddings and positions) go through both.

Tolerances: logits within ``TOL`` = 1e-5 absolute of the reference's
(float32 sums in another order, and ``exp`` / ``expm1`` / ``log_sigmoid``
an ulp apart between torch and XLA); each cache and state field within
``TOL`` times the larger of 1 and its largest magnitude (the sLSTM's and
mLSTM's cell, normalizer and log-space stabilizer grow over the sequence
to ~20, and carry their rounding forward through the recurrence); greedy
ids equal. The layer functions (``chunked_attention_skip``, ``rglru_scan``,
``mlstm_chunked``, ``slstm_scan``) within ``FN_TOL`` = 2e-6 of the
reference's on inputs of magnitude ~1, and the scans within 2e-6 of the
port's own one-step updates, by the same rule (outputs and states scaled
by their largest magnitude where it exceeds 1). Every oracle is a ``jax.jit`` program,
compiled once per config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import model as jlm
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro.models.config import ModelConfig as JModelConfig
from repro.train import serve as jserve
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
from repro_torch.models import blocks, model, rglru, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.train import serve as tserve

TOL = 1e-5
FN_TOL = 2e-6
BATCH, PROMPT, STEPS = 2, 24, 6
#: Causal families; the prompt outruns the reduced local windows (16).
ARCHS = ("gemma3-4b", "chatglm3-6b", "qwen2-vl-72b", "recurrentgemma-9b", "xlstm-125m")
#: The port's attention arms, each held to the reference's chunked arm:
#: "skip" is chunked attention with ``attn_block_skip`` (the reference's
#: dynamic-bounds form in a prefill).
IMPLS = ("chunked", "pallas", "skip")


def _numpy_params(jcfg, seed=0):
    """Weights in the reference's tree, made with numpy: each matrix normal
    over the square root of its input width (the embedding's: of its model
    width); norm scales and biases 0.1·normal; the RG-LRU's Λ and the
    mLSTM's gate biases and skip as the reference initializes them, plus
    0.1·normal noise on the skip and the input-gate biases."""
    shapes = jax.eval_shape(lambda key: jlm.init_params(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    h = jcfg.n_heads

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape, dtype=np.float32)
        if name in ("scale", "b", "b_a", "b_i"):
            return 0.1 * x
        if name == "lam":
            dr = s.shape[-1]
            lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, dr, dtype=np.float32))
                                  / jcfg.rglru_c)).astype(np.float32)
            return np.broadcast_to(lam, s.shape).copy()
        if name == "b_gates":
            forget = 3.0 + np.arange(h, dtype=np.float32) / h
            return np.concatenate([0.1 * x[..., :h], np.broadcast_to(forget, x[..., h:].shape)],
                                  axis=-1)
        if name == "skip":
            return 1.0 + 0.1 * x
        return x * np.float32(s.shape[-1 if name == "embed" else -2] ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(cfg, batch, seq, seed=1):
    """numpy model inputs: ids, or embeddings (and M-RoPE's three streams)."""
    rng = np.random.default_rng(seed)
    if not cfg.embeds_input:
        return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)}
    out = {"embeds": rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)}
    if cfg.rope_variant == "mrope":
        out["positions"] = tlaunch.mrope_positions(batch, seq).numpy()
    return out


def _close(got, want, tol):
    """Within ``tol`` times the larger of 1 and ``want``'s largest finite
    magnitude (equal infinities pass)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def _cache_list(caches):
    return [[t.numpy() for t in tlaunch.cache_tensors(c)] for c in caches]


def _caches_close(jtree, tcaches, cfg):
    """Every layer's cache leaves against the reference's, by field."""
    want = _cache_list(convert.lm_cache_from_numpy(jtree, cfg, device="cpu"))
    got = _cache_list(tcaches)
    assert len(want) == len(got) == cfg.n_layers
    for i, (w_layer, g_layer) in enumerate(zip(want, got)):
        for j, (w, g) in enumerate(zip(w_layer, g_layer)):
            assert w.shape == g.shape, (i, j)
            _close(g, w, TOL)


def _reference_run(arch):
    jcfg, tcfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    tree = _numpy_params(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    tparams = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    inputs = _inputs(jcfg, BATCH, PROMPT)
    max_len = PROMPT + STEPS + 1
    jsc = jserve.ServeConfig(max_len=max_len, cache_dtype="float32")
    tsc = tserve.ServeConfig(max_len=max_len, cache_dtype="float32")

    @jax.jit
    def jprefill(p, x):
        logits, _, caches = jlm.forward(p, jcfg, mode="prefill", cache_len=max_len,
                                        remat=False, **x)
        return logits[:, -1], caches

    jl, jcache = jprefill(params, jax.tree.map(jnp.asarray, inputs))
    out = {"tree": tree, "tparams": tparams, "inputs": inputs,
           "want": (np.asarray(jl), jax.tree.map(np.asarray, jcache)), "prefill": {}}
    tin = {k: torch.tensor(v) for k, v in inputs.items()}
    for impl in IMPLS:
        tc = dataclasses.replace(tcfg, attn_impl="pallas" if impl == "pallas" else "chunked",
                                 attn_block_skip=impl == "skip")
        tl, tcache = tserve.make_prefill_step(tc, tsc)(tparams, tin)
        out["prefill"][impl] = (tl.numpy(), tcache)
    # Greedy decode from the chunked arm's caches, step by step on both.
    jdec = jax.jit(jserve.make_decode_step(jcfg, jsc))
    tdec = tserve.make_decode_step(tcfg, tsc)
    jn = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tn = torch.argmax(torch.tensor(out["prefill"]["chunked"][0]), -1)[:, None].to(torch.int32)
    tcache = out["prefill"]["chunked"][1]
    tcache = convert.lm_cache_from_numpy(convert.lm_cache_to_numpy(tcache, tcfg), tcfg, "cpu")
    steps = []
    for i in range(STEPS):
        jn, jlf, jcache = jdec(params, jcache, jn, jnp.asarray(PROMPT + i, jnp.int32))
        tn, tlf, tcache = tdec(tparams, tcache, tn, PROMPT + i)
        steps.append((np.asarray(jn), np.asarray(jlf), tn.numpy(), tlf.numpy()))
    out["decode"] = steps
    out["decode_caches"] = (jax.tree.map(np.asarray, jcache), tcache)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return request.param, _reference_run(request.param)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_caches_match_reference(run, impl):
    arch, r = run
    jl, jcache = r["want"]
    tl, tcache = r["prefill"][impl]
    assert tl.shape == jl.shape == (BATCH, tconfigs.reduced(arch).vocab_size)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    _caches_close(jcache, tcache, tconfigs.reduced(arch))


def test_greedy_decode_matches_reference(run):
    arch, r = run
    for jn, jlf, tn, tlf in r["decode"]:
        np.testing.assert_allclose(tlf, jlf, rtol=0, atol=TOL)
        np.testing.assert_array_equal(tn, jn)
    _caches_close(r["decode_caches"][0], r["decode_caches"][1], tconfigs.reduced(arch))


def test_params_and_caches_round_trip_through_numpy(run):
    """Parameters both ways bitwise; the reference's empty serving caches
    (stabilizers at −inf) into the port and back, −inf kept."""
    arch, r = run
    cfg, jcfg = tconfigs.reduced(arch), jconfigs.reduced(arch)
    back = convert.lm_params_to_numpy(r["tparams"], cfg)
    want, got = jax.tree_util.tree_flatten(r["tree"]), jax.tree_util.tree_flatten(back)
    assert want[1] == got[1]
    assert all(np.array_equal(a, b) for a, b in zip(want[0], got[0]))
    empty = jax.tree.map(np.asarray, jlm.init_cache(jcfg, BATCH, 8, jnp.float32))
    caches = convert.lm_cache_from_numpy(empty, cfg, device="cpu")
    mine = tserve.init_serve_cache(cfg, tserve.ServeConfig(max_len=8, cache_dtype="float32"),
                                   BATCH)
    for a, b in zip(_cache_list(caches), _cache_list(mine)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    again = jax.tree_util.tree_leaves(convert.lm_cache_to_numpy(caches, cfg))
    leaves = jax.tree_util.tree_leaves(empty)
    assert len(again) == len(leaves)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, again))
    if cfg.has_recurrence and arch == "xlstm-125m":
        assert any(np.isneginf(x).all() for x in leaves)


def test_hubert_bidirectional_forward_matches_reference():
    """Encoder-only: embeddings in, every position's logits, both arms of
    the port (the pallas arm with ``causal=False``) against the reference."""
    arch = "hubert-xlarge"
    jcfg, tcfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    tree = _numpy_params(jcfg)
    x = _inputs(jcfg, BATCH, 37)["embeds"]  # ragged: no multiple of the chunk (32)
    want = np.asarray(jax.jit(lambda p, e: jlm.forward(p, jcfg, embeds=e, remat=False)[0])(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    tparams = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    for impl in ("chunked", "pallas"):
        got = model.forward(tparams, dataclasses.replace(tcfg, attn_impl=impl),
                            embeds=torch.tensor(x))[0].numpy()
        assert got.shape == want.shape == (BATCH, 37, tcfg.vocab_size)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="encoder-only"):
        tlaunch.serve(arch, device="cpu")


#: (sq, skv, h, hk, causal, window, chunk, q_offset) for chunked_attention_skip.
SKIP_CASES = {
    "causal": (64, 64, 4, 2, True, 0, 16, 0),
    "window": (64, 64, 4, 1, True, 20, 16, 0),
    "window-offset": (32, 64, 2, 2, True, 24, 16, 32),
    "noncausal-window": (48, 48, 2, 1, False, 16, 16, 0),
    "ragged-fallback": (40, 40, 4, 2, True, 12, 16, 0),
}


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_chunked_attention_skip_matches_reference(case, static):
    sq, skv, h, hk, causal, window, chunk, q_offset = SKIP_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, sq, h, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, skv, hk, 16), dtype=np.float32) for _ in range(2))
    kw = dict(q_offset=q_offset, causal=causal, window=window, chunk=chunk)
    want = np.asarray(jax.jit(lambda a, b, c: jblocks.chunked_attention_skip(
        a, b, c, static=static, **kw))(q, k, v))
    got = blocks.chunked_attention_skip(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                        static=static, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FN_TOL)
    plain = blocks.chunked_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                     **kw).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=FN_TOL)


def _layer_cfgs(**kw):
    base = dict(name="rec", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
                vocab_size=8, ffn_variant="none", chunk_len=8)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _block_params(tree_fn, jcfg, seed):
    """A block's parameters made with numpy by ``_numpy_params``'s rules."""
    shapes = jax.eval_shape(lambda key: tree_fn(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape, dtype=np.float32)
        if name == "lam":
            return np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, s.shape[-1],
                                                       dtype=np.float32)) / jcfg.rglru_c))
        if len(s.shape) < 2:  # biases, norm scales
            return 0.1 * x
        return x * np.float32(s.shape[-2] ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_rglru_scan_matches_reference_and_step():
    """The doubling scan against the reference's associative scan and
    against the one-step update in a loop, from a nonzero state, at a
    length that is no power of two."""
    jcfg, tcfg = _layer_cfgs(layer_pattern=("rglru",))
    p = _block_params(jrglru.init_rglru_block, jcfg, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, 64), dtype=np.float32)
    h0 = rng.standard_normal((2, 64), dtype=np.float32)
    jh, jfinal = jax.jit(lambda pp, a, b: jrglru.rglru_scan(pp, a, jcfg, b))(p, x, h0)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    th, tfinal = rglru.rglru_scan(tp, torch.tensor(x), tcfg, torch.tensor(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=FN_TOL)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), rtol=0, atol=FN_TOL)
    h = torch.tensor(h0)
    for t in range(x.shape[1]):
        _, h = rglru.rglru_step(tp, torch.tensor(x[:, t]), tcfg, h)
        np.testing.assert_allclose(th[:, t].numpy(), h.numpy(), rtol=0, atol=FN_TOL)


def test_mlstm_chunked_matches_reference_and_step():
    """Chunkwise mLSTM (a ragged tail: 29 steps in chunks of 8) against the
    reference's and against the sequential step from the zero state (m at
    −inf), outputs and final state."""
    rng = np.random.default_rng(6)
    b, s, h, dh = 2, 29, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, dh), dtype=np.float32) for _ in range(3))
    k = k * np.float32(dh ** -0.5)
    i_log = rng.standard_normal((b, s, h), dtype=np.float32)
    f_log = np.log(1.0 / (1.0 + np.exp(-(2.0 + rng.standard_normal((b, s, h)))))).astype(
        np.float32)
    st = jxlstm.mlstm_zero_state(b, h, dh)
    jh, jst = jax.jit(lambda *a: jxlstm.mlstm_chunked(*a, st, 8))(q, k, v, i_log, f_log)
    t = [torch.tensor(a) for a in (q, k, v, i_log, f_log)]
    th, tst = xlstm.mlstm_chunked(*t, xlstm.mlstm_zero_state(b, h, dh), 8)
    _close(th, jh, FN_TOL)
    for a, w in zip(tst, jst):
        _close(a, w, FN_TOL)
    state = xlstm.mlstm_zero_state(b, h, dh)
    assert torch.isneginf(state.m).all()
    for i in range(s):
        state, hi = xlstm.mlstm_step(state, *(x[:, i] for x in t))
        assert torch.isfinite(hi).all()
        _close(th[:, i], hi, FN_TOL)
    for a, w in zip(tst, state):
        _close(a, w, FN_TOL)


def test_slstm_scan_matches_reference():
    jcfg, tcfg = _layer_cfgs(layer_pattern=("slstm",))
    p = _block_params(jxlstm.init_slstm_block, jcfg, 7)
    x = np.random.default_rng(8).standard_normal((2, 19, 64), dtype=np.float32)
    st = jxlstm.slstm_zero_state(2, 4, 16)
    jy, jst = jax.jit(lambda pp, a: jxlstm.slstm_scan(pp, a, jcfg, st))(
        {k: p[k] for k in ("w_x", "r", "b")}, x)
    tp = {k: torch.tensor(np.asarray(p[k])) for k in ("w_x", "r", "b")}
    ty, tst = xlstm.slstm_scan(tp, torch.tensor(x), tcfg, xlstm.slstm_zero_state(2, 4, 16))
    _close(ty, jy, FN_TOL)
    for a, w in zip(tst, jst):
        _close(a, w, FN_TOL)


@pytest.mark.parametrize("arch", ARCHS + ("hubert-xlarge",))
def test_param_count_matches_reference(arch):
    """Analytic counts equal the reference's, reduced and full; the port's
    own reduced init draws exactly that many."""
    for get in ("get", "reduced"):
        assert getattr(tconfigs, get)(arch).param_count() == getattr(jconfigs, get)(
            arch).param_count()
    cfg = tconfigs.reduced(arch)
    p = model.init_params(torch.Generator().manual_seed(0), cfg)
    assert sum(a.size for a in jax.tree_util.tree_leaves(
        convert.lm_params_to_numpy(p, cfg))) == cfg.param_count()
