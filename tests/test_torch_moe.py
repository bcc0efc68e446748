"""The port's experts (``models/moe.py``) vs the JAX reference, on the CPU.

The same numpy inputs and weights go through the reference's functions and
the port's:

* ``route``: weights within ``W_TOL`` = 1e-6, expert ids equal (in order:
  exact ties go to the lower index, as ``jax.lax.top_k`` orders them — a
  router with two equal columns makes every token's pair tie), aux within
  ``AUX_TOL`` = 1e-6 (a mean is a sum times 1/n in XLA, a division in
  torch);
* ``_dispatch_compute_combine`` at a capacity factor of 0.5, so tokens are
  dropped, over the whole expert range and over two ranges that make it up
  (the expert-parallel branch's local calls), and ``moe_forward`` with its
  shared experts: outputs within ``TOL`` = 1e-5 (float32 products summed
  in another order), aux within 1e-6;
* the reduced deepseek-moe-16b and kimi-k2-1t-a32b, weights through
  ``convert``: prefill and 8 greedy decode steps through ``train/serve.py``
  against the reference's steps (capacity couples the tokens of a batch, so
  the port is held to the reference's own prefill and decode, never to a
  forward over the whole sequence): logits within 1e-5, caches within 1e-5,
  greedy ids equal, every routing's expert ids equal to the reference's
  ``route`` on the same layer input, the model's summed aux within 1e-6;
* ``count_params_analytic``, total and active, against the reference's.

Every oracle is a ``jax.jit`` program, compiled once per shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model as jlm
from repro.models import moe as jmoe
from repro.train import serve as jserve
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model, moe
from repro_torch.train import serve as tserve
from repro_torch.tree import tree_map

TOL = 1e-5
W_TOL = 1e-6
AUX_TOL = 1e-6
ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
BATCH, PROMPT, STEPS = 2, 24, 8

_jroute = jax.jit(jmoe.route, static_argnums=2)
_jdispatch = jax.jit(jmoe._dispatch_compute_combine, static_argnums=(5, 6, 7))
_jmoe_forward = jax.jit(jmoe.moe_forward, static_argnums=2)


def _tight(cfg):
    """``cfg`` at a capacity factor of 0.5: half the tokens' assignments fit."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


def _layer(seed=0):
    """A MoE layer of the reduced deepseek config in numpy (each matrix
    normal over the square root of its input width, the shared FFN's too)
    and a (2, 24, d) input of magnitude ~1."""
    cfg = jconfigs.reduced("deepseek-moe-16b")
    d, m = cfg.d_model, cfg.moe
    f, e = m.d_ff_expert, m.n_experts
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(shape[-2] ** -0.5)

    p = {"router": normal(d, e), "w_gate": normal(e, d, f), "w_up": normal(e, d, f),
         "w_down": normal(e, f, d),
         "shared": {"w_gate": normal(d, m.n_shared * f), "w_up": normal(d, m.n_shared * f),
                    "w_down": normal(m.n_shared * f, d)}}
    x = rng.standard_normal((BATCH, PROMPT, d), dtype=np.float32)
    return p, x


def _torch_tree(tree):
    return tree_map(torch.tensor, tree)


@pytest.mark.parametrize("ties", [False, True])
def test_route_matches_reference(ties):
    p, x = _layer()
    if ties:  # experts 3 and 5 get equal probabilities on every token
        p["router"][:, 5] = p["router"][:, 3]
    x_flat = x.reshape(-1, x.shape[-1])
    jcfg, tcfg = jconfigs.reduced("deepseek-moe-16b"), tconfigs.reduced("deepseek-moe-16b")
    jw, jidx, jaux = (np.asarray(a) for a in _jroute({"router": p["router"]}, x_flat, jcfg))
    w, idx, aux = moe.route({"router": torch.tensor(p["router"])}, torch.tensor(x_flat), tcfg)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=W_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    if ties:
        both = (jidx == 3).any(-1) & (jidx == 5).any(-1)
        assert both.any()  # tie pairs inside the top k, ordered 3 before 5
        assert (np.argmax(jidx == 3, -1) < np.argmax(jidx == 5, -1))[both].all()


def test_dispatch_drops_tokens_as_the_reference_does():
    """Whole range and two ranges that make it up, at a capacity that drops
    assignments; the two partial outputs sum to the whole one."""
    p, x = _layer(1)
    jcfg = _tight(jconfigs.reduced("deepseek-moe-16b"))
    tcfg = _tight(tconfigs.reduced("deepseek-moe-16b"))
    e = tcfg.moe.n_experts
    x_flat = x.reshape(-1, x.shape[-1])
    t, k = x_flat.shape[0], tcfg.moe.top_k
    cap = max(moe._round_up(int(t * k / e * tcfg.moe.capacity_factor), 8), 8)
    _, idx, _ = moe.route({"router": torch.tensor(p["router"])}, torch.tensor(x_flat), tcfg)
    dropped = int(torch.clamp_min(torch.bincount(idx.reshape(-1), minlength=e) - cap, 0).sum())
    assert cap == 8 and dropped > 0
    assert moe.capacity(t, tcfg) == jmoe.capacity(t, jcfg) == 128  # the reference's other rule
    parts = []
    for lo, count in ((0, e), (0, e // 2), (e // 2, e - e // 2)):
        ws = [p[n][lo:lo + count] for n in ("w_gate", "w_up", "w_down")]
        jy, jaux = _jdispatch(p["router"], *ws, x_flat, jcfg, lo, count)
        y, aux = moe._dispatch_compute_combine(torch.tensor(p["router"]),
                                               *(torch.tensor(w) for w in ws),
                                               torch.tensor(x_flat), tcfg, lo, count)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
        assert abs(float(aux) - float(jaux)) <= AUX_TOL
        parts.append(y)
    np.testing.assert_allclose((parts[1] + parts[2]).numpy(), parts[0].numpy(), rtol=0, atol=TOL)


def test_moe_forward_matches_reference():
    p, x = _layer(2)
    jcfg, tcfg = jconfigs.reduced("deepseek-moe-16b"), tconfigs.reduced("deepseek-moe-16b")
    jy, jaux = _jmoe_forward(p, x, jcfg)
    y, aux = moe.moe_forward(_torch_tree(p), torch.tensor(x), tcfg)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


def _numpy_params(jcfg, seed=0):
    """Weights in the reference's tree, made with numpy: each matrix normal
    over the square root of its input width (the embedding's: of its model
    width), norm scales 0.1·normal."""
    shapes = jax.eval_shape(lambda key: jlm.init_params(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape, dtype=np.float32)
        if path[-1].key == "scale":
            return 0.1 * x
        return x * np.float32(s.shape[-1 if path[-1].key == "embed" else -2] ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, tol):
    """Within ``tol`` times the larger of 1 and ``want``'s largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _reference_run(arch):
    """Prefill and ``STEPS`` greedy decode steps on both packages, the port's
    routings recorded with their inputs."""
    jcfg, tcfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    tree = _numpy_params(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    tparams = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (BATCH, PROMPT),
                                                dtype=np.int32)
    max_len = PROMPT + STEPS + 1
    jsc = jserve.ServeConfig(max_len=max_len, cache_dtype="float32")
    tsc = tserve.ServeConfig(max_len=max_len, cache_dtype="float32")

    @jax.jit
    def jprefill(p, tokens):
        logits, aux, caches = jlm.forward(p, jcfg, tokens=tokens, mode="prefill",
                                          cache_len=max_len, remat=False)
        return logits[:, -1], aux, caches

    jl, jaux, jcache = jprefill(params, jnp.asarray(prompts))
    taux = model.forward(tparams, tcfg, tokens=torch.tensor(prompts))[1]
    routed = []  # (call, x_flat, experts, weights) of every port routing
    inner, call = moe._route, [0]

    def spy(router, x_flat, m):
        out = inner(router, x_flat, m)
        routed.append((call[0], x_flat, out[1], out[0]))
        return out

    moe._route = spy
    try:
        tl, tcache = tserve.make_prefill_step(tcfg, tsc)(tparams,
                                                         {"tokens": torch.tensor(prompts)})
        out = {"tree": tree, "tparams": tparams, "routed": routed,
               "prefill": (np.asarray(jl), jax.tree.map(np.asarray, jcache), tl.numpy(), tcache),
               "aux": (float(jaux), float(taux))}
        jdec = jax.jit(jserve.make_decode_step(jcfg, jsc))
        tdec = tserve.make_decode_step(tcfg, tsc)
        jn = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tn = torch.argmax(tl, -1)[:, None].to(torch.int32)
        tcache = [c._replace(k=c.k.clone(), v=c.v.clone()) for c in tcache]  # decode writes in place
        steps = []
        for i in range(STEPS):
            call[0] = i + 1
            jn, jlf, jcache = jdec(params, jcache, jn, jnp.asarray(PROMPT + i, jnp.int32))
            tn, tlf, tcache = tdec(tparams, tcache, tn, PROMPT + i)
            steps.append((np.asarray(jn), np.asarray(jlf), tn.numpy(), tlf.numpy()))
    finally:
        moe._route = inner
    out["decode"] = steps
    out["decode_caches"] = (jax.tree.map(np.asarray, jcache), tcache)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return request.param, _reference_run(request.param)


def _caches_close(jtree, tcaches, cfg):
    want = convert.lm_cache_from_numpy(jtree, cfg, device="cpu")
    assert len(want) == len(tcaches) == cfg.n_layers
    for w, t in zip(want, tcaches):
        for a, b in zip(tlaunch.cache_tensors(t), tlaunch.cache_tensors(w)):
            assert a.shape == b.shape
            _close(a.numpy(), b.numpy(), TOL)


def test_prefill_logits_caches_and_aux_match_reference(run):
    arch, r = run
    cfg = tconfigs.reduced(arch)
    jl, jcache, tl, tcache = r["prefill"]
    assert tl.shape == jl.shape == (BATCH, cfg.vocab_size)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    _caches_close(jcache, tcache, cfg)
    jaux, taux = r["aux"]
    assert jaux > 0.0 and abs(taux - jaux) <= AUX_TOL


def test_greedy_decode_matches_reference(run):
    arch, r = run
    for jn, jlf, tn, tlf in r["decode"]:
        np.testing.assert_allclose(tlf, jlf, rtol=0, atol=TOL)
        np.testing.assert_array_equal(tn, jn)
    _caches_close(r["decode_caches"][0], r["decode_caches"][1], tconfigs.reduced(arch))


def test_every_routing_matches_reference_route(run):
    """Each MoE layer's routing in the prefill and every decode step: the
    port's expert ids equal (and weights within 1e-6 of) the reference's
    ``route`` of that layer on the same input."""
    arch, r = run
    jcfg, cfg = jconfigs.reduced(arch), tconfigs.reduced(arch)
    moe_layers = [i for i in range(cfg.n_layers) if cfg.uses_moe(i)]
    calls = [c for c, *_ in r["routed"]]
    assert calls == [c for c in range(STEPS + 1) for _ in moe_layers]
    for n, (_, x_flat, idx, w) in enumerate(r["routed"]):
        router = r["tparams"]["stack"][moe_layers[n % len(moe_layers)]]["mix"]["router"]
        jw, jidx, _ = _jroute({"router": router.numpy()}, x_flat.numpy(), jcfg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=W_TOL)


def test_params_round_trip_through_numpy(run):
    """The expert tree both ways bitwise: group-stacked (G, E, d, f) leaves,
    the float32 router and the shared FFN."""
    arch, r = run
    cfg = tconfigs.reduced(arch)
    back = convert.lm_params_to_numpy(r["tparams"], cfg)
    want, got = jax.tree_util.tree_flatten(r["tree"]), jax.tree_util.tree_flatten(back)
    assert want[1] == got[1]
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(want[0], got[0]))
    mix = r["tparams"]["stack"][cfg.first_k_dense]["mix"]
    m = cfg.moe
    assert mix["w_gate"].shape == (m.n_experts, cfg.d_model, m.d_ff_expert)
    assert mix["router"].dtype == torch.float32 and "shared" in mix


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_count_matches_reference(arch):
    """Total and active counts, full and reduced, equal the reference's (a
    config without experts has no active count of its own: the reference
    returns its total, so its reduced config's is asked and its full one's
    total, held by the families' tests, stands for both)."""
    for get in ("get", "reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        if tcfg.moe is None and get == "get":
            assert tcfg.active_param_count() == tcfg.param_count()
            continue
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
    full = tconfigs.get(arch)
    if arch == "deepseek-moe-16b":
        assert (full.param_count(), full.active_param_count()) == (16_375_728_128,
                                                                   2_828_650_496)


def test_card_vs_cpu_counts_a_routing_flip_and_leaves_out_later_rows(monkeypatch):
    """``compare_card_to_cpu`` on the CPU (both sides the plain path) with
    the first routing of the "card" side given another last expert for
    token 0: one flip is found, in the first routing compared; it is a
    near-tie only if the CPU's gap says so; the caches and every logit row
    from the prefill on are left out."""
    inner, calls = moe._route, []

    def flip_first(router, x_flat, m):
        w, idx, probs, aux = inner(router, x_flat, m)
        calls.append(1)
        if len(calls) == 1:
            ranked = torch.sort(probs[0], descending=True, stable=True).indices
            idx = idx.clone()
            idx[0, -1] = ranked[m.top_k]
            gap = float(probs[0, ranked[m.top_k - 1]] - probs[0, ranked[m.top_k]])
            calls.append(gap)
            moe._route_log[-1] = (idx, probs)  # as if the card had routed so
        return w, idx, probs, aux

    monkeypatch.setattr(moe, "_route", flip_first)
    r = tlaunch.compare_card_to_cpu("deepseek-moe-16b", "cpu", batch=2, prompt_len=8, steps=2)
    gap = calls[1]
    assert r["moe_calls"] == 1 and r["route_flips"] == 1
    assert r["flips_not_near_tie"] == int(gap > tlaunch.FLIP_EPS)
    assert r["flip_max_gap"] == pytest.approx(gap, abs=1e-7)
    assert r["excluded_rows"] == 2 * 3 and r["sure"] == 0 and not r["cache_compared"]
