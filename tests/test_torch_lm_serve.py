"""The port's LM serving path vs the JAX reference, on the CPU.

Random weights in the reference's parameter tree (the shapes of
``repro.models.model.init_params``, the values made with numpy from a seed)
go into the reference as they are and into the port through
``convert.lm_params_from_numpy``, and the same numpy prompt ids go through
both packages:

* prefill last-position logits and every layer's KV cache within 1e-5 of
  the reference's (float32 matrix products sum in another order), through
  both attention arms — ``"chunked"`` and ``"pallas"`` (the reference's
  Pallas kernel in interpret mode; the port's plain flash attention);
* then 8 greedy decode steps with equal ids and logits within 1e-5;
* ``launch.serve.serve`` end to end on the CPU with the reference's weights,
  rope variants against the reference, parameter counts, and that every
  architecture loads (experts: ``tests/test_torch_moe.py``).

Reduced Llama-3.2-3B (GQA group 2, dh 32) and reduced SmolLM-135M (tied
embeddings, GQA group 3) as the reference's configs give them, plus one
small local/global config for the rolling window cache.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model as jlm
from repro.models import rope as jrope
from repro.models.config import ModelConfig as JModelConfig
from repro.train import serve as jserve
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
from repro_torch.models import blocks, model, rope
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.train import serve as tserve

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
BATCH, PROMPT, STEPS = 2, 24, 8
ARCHS = ("llama3.2-3b", "smollm-135m")

#: A small local/global config (gemma-like: qk_norm, geglu, a separate
#: global theta) whose prompt outruns the window, so the rolling slots fill.
LOCAL_KW = dict(name="local-global", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=96, vocab_size=256, layer_pattern=("local", "global"), window=8,
                qk_norm=True, ffn_variant="geglu", rope_theta_global=1e6, chunk_len=16)


def _numpy_params(jcfg, seed=0):
    """Weights in the reference's tree, made with numpy: each matrix normal
    over the square root of its input width (the embedding's: of its model
    width), as the reference's init scales them; each norm scale 0.1·normal
    around the reference's 0, so the norms' gains are exercised too. (The
    reference's own init compiles one program for every leaf shape: seconds
    on the CPU.)"""
    shapes = jax.eval_shape(lambda key: jlm.init_params(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape, dtype=np.float32)
        if path[-1].key == "scale":
            return 0.1 * x
        return x * np.float32(s.shape[-1 if path[-1].key == "embed" else -2] ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _reference_run(jcfg, tcfg, batch, prompt, steps, impls, jax_impls=None):
    """Both packages on the same weights and one numpy prompt: per
    attention arm the prefill (the reference's ``jax_impls[i]`` arm beside
    the port's ``impls[i]``), then greedy decode from the first arm."""
    tree = _numpy_params(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    tparams = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (batch, prompt),
                                                dtype=np.int32)
    max_len = prompt + steps + 1
    jsc = jserve.ServeConfig(max_len=max_len, cache_dtype="float32")
    tsc = tserve.ServeConfig(max_len=max_len, cache_dtype="float32")
    out = {"tree": tree, "tparams": tparams, "prompts": prompts, "prefill": {}}
    jax_out = {}
    for impl, jimpl in zip(impls, jax_impls or impls):
        jc = dataclasses.replace(jcfg, attn_impl=jimpl)
        tc = dataclasses.replace(tcfg, attn_impl=impl)
        if jimpl not in jax_out:
            jax_out[jimpl] = jax.jit(jserve.make_prefill_step(jc, jsc))(
                params, {"tokens": jnp.asarray(prompts)})
        jl, jcache = jax_out[jimpl]
        tl, tcache = tserve.make_prefill_step(tc, tsc)(tparams,
                                                       {"tokens": torch.tensor(prompts)})
        out["prefill"][impl] = (np.asarray(jl), jax.tree.map(np.asarray, jcache),
                                tl.numpy(), tcache)
    jl, jcache, tl, tcache = out["prefill"][impls[0]]
    jdec = jax.jit(jserve.make_decode_step(jcfg, jsc))
    tdec = tserve.make_decode_step(tcfg, tsc)
    jn = jnp.argmax(jnp.asarray(jl), -1)[:, None].astype(jnp.int32)
    tn = torch.argmax(torch.tensor(tl), -1)[:, None].to(torch.int32)
    jcache = jax.tree.map(jnp.asarray, jcache)
    tcache = [blocks.KVCache(c.k.clone(), c.v.clone()) for c in tcache]
    steps_out = []
    for i in range(steps):
        jn, jlf, jcache = jdec(params, jcache, jn, jnp.asarray(prompt + i, jnp.int32))
        tn, tlf, tcache = tdec(tparams, tcache, tn, prompt + i)
        steps_out.append((np.asarray(jn), np.asarray(jlf), tn.numpy(), tlf.numpy()))
    out["decode"] = steps_out
    out["decode_caches"] = (jax.tree.map(np.asarray, jcache), tcache)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    arch = request.param
    return arch, _reference_run(jconfigs.reduced(arch), tconfigs.reduced(arch), BATCH,
                                PROMPT, STEPS, ("chunked", "pallas"))


def _caches_close(jtree, tcaches, cfg):
    want = convert.lm_cache_from_numpy(jtree, cfg, device="cpu")
    assert len(want) == len(tcaches) == cfg.n_layers
    for w, t in zip(want, tcaches):
        assert w.k.shape == t.k.shape and w.v.shape == t.v.shape
        np.testing.assert_allclose(t.k.numpy(), w.k.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(t.v.numpy(), w.v.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_logits_and_caches_match_reference(run, impl):
    arch, r = run
    jl, jcache, tl, tcache = r["prefill"][impl]
    assert tl.shape == jl.shape == (BATCH, tconfigs.reduced(arch).vocab_size)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    _caches_close(jcache, tcache, tconfigs.reduced(arch))


def test_greedy_decode_matches_reference(run):
    arch, r = run
    for jn, jlf, tn, tlf in r["decode"]:
        np.testing.assert_allclose(tlf, jlf, rtol=0, atol=TOL)
        np.testing.assert_array_equal(tn, jn)
    _caches_close(r["decode_caches"][0], r["decode_caches"][1], tconfigs.reduced(arch))


def test_serve_end_to_end_on_cpu_with_reference_weights(run):
    """``serve`` with the reference's weights and prompts returns the
    reference's greedy ids: the prefill's argmax, then the decode steps."""
    arch, r = run
    want = np.concatenate([np.argmax(r["prefill"]["chunked"][0], -1)[:, None]]
                          + [jn for jn, _, _, _ in r["decode"]], axis=1)
    for impl in ("pallas", "chunked"):
        ids, rep = tlaunch.serve(arch, gen=STEPS + 1, device="cpu", attn_impl=impl,
                                 params=r["tparams"], prompts=torch.tensor(r["prompts"]),
                                 return_report=True)
        np.testing.assert_array_equal(ids.numpy(), want)
        assert rep["logits_finite"] and rep["peak_device_bytes"] is None


def test_params_round_trip_through_numpy(run):
    arch, r = run
    back = convert.lm_params_to_numpy(r["tparams"], tconfigs.reduced(arch))
    want, got = jax.tree_util.tree_flatten(r["tree"]), jax.tree_util.tree_flatten(back)
    assert want[1] == got[1]
    assert all(np.array_equal(a, b) for a, b in zip(want[0], got[0]))


def test_prefill_last_logits_match_full_head(run):
    """The serving prefill's head at the last position only gives the last
    row of the full head's logits, and the same caches."""
    arch, r = run
    cfg = tconfigs.reduced(arch)
    tokens = torch.tensor(r["prompts"])
    full, _, fcache = model.prefill(r["tparams"], cfg, PROMPT + 1, tokens=tokens)
    last, _, lcache = model.prefill(r["tparams"], cfg, PROMPT + 1, tokens=tokens,
                                    last_logits=True)
    assert tuple(last.shape) == (BATCH, 1, cfg.vocab_size)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), rtol=0, atol=TOL)
    for f, c in zip(fcache, lcache):
        assert torch.equal(f.k, c.k) and torch.equal(f.v, c.v)


def test_local_window_cache_matches_reference():
    """Local (sliding-window) and global layers, qk-norm, GeGLU: prefill
    past the window fills the rolling slots, decode wraps them. Both of the
    port's arms are held to the reference's chunked arm."""
    r = _reference_run(JModelConfig(**LOCAL_KW), ModelConfig(**LOCAL_KW), 2, 12, 5,
                       ("chunked", "pallas"), jax_impls=("chunked", "chunked"))
    cfg = ModelConfig(**LOCAL_KW)
    for impl in ("chunked", "pallas"):
        jl, jcache, tl, tcache = r["prefill"][impl]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
        _caches_close(jcache, tcache, cfg)
        assert tcache[0].k.shape[1] == cfg.window
    for jn, jlf, tn, tlf in r["decode"]:
        np.testing.assert_allclose(tlf, jlf, rtol=0, atol=TOL)
        np.testing.assert_array_equal(tn, jn)
    _caches_close(r["decode_caches"][0], r["decode_caches"][1], cfg)
    empty = tserve.init_serve_cache(cfg, tserve.ServeConfig(max_len=20, cache_dtype="float32"),
                                    batch=2)
    assert [tuple(c.k.shape) for c in empty] == [(2, 8, 2, 16), (2, 20, 2, 16)]
    assert all(c.v.dtype == torch.float32 and not c.v.any() for c in empty)


@pytest.mark.parametrize("variant", ["half", "mrope"])
def test_rope_matches_reference(variant):
    """The partial and M-RoPE variants ("full" runs in every model test)."""
    kw = dict(name="rope", n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
              vocab_size=8, rope_variant=variant, rope_theta=500_000.0,
              mrope_sections=(2, 3, 3))
    x = np.random.default_rng(2).standard_normal((2, 9, 4, 16), dtype=np.float32)
    jpos = jrope.default_positions(JModelConfig(**kw), 2, 9, 5)
    tpos = rope.default_positions(ModelConfig(**kw), 2, 9, 5)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    want = np.asarray(jax.jit(lambda a, p: jrope.apply_rope(a, p, JModelConfig(**kw)))(
        jnp.asarray(x), jpos))
    got = rope.apply_rope(torch.tensor(x), tpos, ModelConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    for get in ("get", "reduced"):
        want = getattr(jconfigs, get)(arch).param_count()
        assert getattr(tconfigs, get)(arch).param_count() == want
    assert tconfigs.get("llama3.2-3b").n_layers == 28


def test_unported_paths_raise():
    """No path is left unported: all ten architectures load, full and
    reduced (an unknown one raises ``KeyError``), and ``moe`` layers
    initialize — a MoE variant of reduced Llama draws its experts' shapes
    from layer ``first_k_dense`` on, counts them, and runs."""
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.get(arch).name == arch
        assert tconfigs.reduced(arch).d_model < tconfigs.get(arch).d_model
    with pytest.raises(KeyError, match="unknown architecture"):
        tconfigs.get("no-such-arch")
    cfg = dataclasses.replace(tconfigs.reduced("llama3.2-3b"), first_k_dense=1,
                              moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff_expert=16))
    p = model.init_params(torch.Generator().manual_seed(0), cfg)
    assert "router" not in p["stack"][0]["mix"]
    mix = p["stack"][1]["mix"]
    d = cfg.d_model
    assert mix["router"].shape == (d, 4) and mix["router"].dtype == torch.float32
    assert mix["w_gate"].shape == mix["w_up"].shape == (4, d, 16)
    assert mix["w_down"].shape == (4, 16, d) and mix["shared"]["w_up"].shape == (d, 16)
    assert sum(a.size for a in jax.tree_util.tree_leaves(
        convert.lm_params_to_numpy(p, cfg))) == cfg.param_count()
    logits, aux, _ = model.forward(p, cfg, tokens=torch.zeros((2, 8), dtype=torch.int32))
    assert logits.shape == (2, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert float(aux) > 0.0


def test_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.serve("llama3.2-3b", batch=1, prompt_len=4, gen=2)


def test_serve_cli_on_cpu_loads_neither_jax_nor_the_reference():
    """``python -m repro_torch.launch.serve --device cpu`` runs and prints
    the reference's report line, with no jax* and no repro.* module loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--device', 'cpu', '--arch', 'smollm-135m', '--batch', '2',\n"
        "            '--prompt-len', '8', '--gen', '3']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] smollm-135m: batch=2 prompt=8 gen=3 | prefill" in out.stdout
    assert "generated ids[0,:16]:" in out.stdout
