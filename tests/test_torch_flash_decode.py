"""The port's flash decode vs the JAX reference, on the CPU.

The same numpy inputs go through the port's plain version
(``ref.flash_decode_plain``, what a CPU tensor runs: GQA KV read by group,
no repeat), the reference's oracle ``ref.decode_attention`` on
head-repeated KV, and the reference's Pallas kernel in interpret mode (one
tiny shape, through its ``ops`` with the head repeat and padding), at GQA
groups 1 to 4 and lengths 1, L − 1 and L. Tolerances: 1e-5 in float32
(sums in another order), 2e-2 in bfloat16 (the result is rounded to
bfloat16), as the reference's own kernel tests state them. An empty cache
(length 0) gives 0 in the kernels' function, as in the Pallas kernel; the
oracle spreads it evenly instead.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import ops as jops
from repro.kernels.flash_decode import ref as jref
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops, ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
L, HK, DH = 40, 2, 64


@jax.jit
def _jref_grouped(q, k, v, length):
    g = q.shape[1] // k.shape[2]
    return jref.decode_attention(q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2), length)


_jinterp = jax.jit(lambda q, k, v, length: jops.flash_decode(
    q, k, v, length, jops.FDConfig(16), interpret=True))


def _inputs(b, h, hk, n, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, dh), dtype=np.float32),
            rng.standard_normal((b, n, hk, dh), dtype=np.float32),
            rng.standard_normal((b, n, hk, dh), dtype=np.float32))


def _both(arrays, dtype):
    return ([torch.tensor(a).to(getattr(torch, dtype)) for a in arrays],
            [jnp.asarray(a).astype(dtype) for a in arrays])


@pytest.mark.parametrize("group,dtype", [(1, "float32"), (2, "float32"), (3, "float32"),
                                         (4, "float32"), (2, "bfloat16")])
def test_plain_matches_reference_oracle(group, dtype):
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, HK * group, HK, L, DH, seed=group), dtype)
    for length in (1, L - 1, L):
        got = ref.flash_decode_plain(q, k, v, length)
        want = _jref_grouped(jq, jk, jv, jnp.int32(length))
        assert got.dtype == q.dtype and got.shape == (2, HK * group, DH)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        # the oracle's own form, on repeated KV, agrees as well
        port_oracle = ref.decode_attention(q, ref.repeat_kv(k, group), ref.repeat_kv(v, group),
                                           length)
        np.testing.assert_allclose(port_oracle.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_matches_interpret_kernel_and_empty_cache_gives_zero():
    (q, k, v), (jq, jk, jv) = _both(_inputs(1, 4, HK, L, DH, seed=7), "float32")
    for length in (0, 1, L - 1, L):
        got = ops.flash_decode(q, k, v, length, ops.WORST_CASE).numpy()
        want = np.asarray(_jinterp(jq, jk, jv, jnp.int32(length)))
        np.testing.assert_allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"])
        if length == 0:
            assert np.all(got == 0.0) and np.all(want == 0.0)
    spread = ref.decode_attention(q, ref.repeat_kv(k, 2), ref.repeat_kv(v, 2), 0)
    assert float(spread.abs().max()) > 0.0           # the oracle's even spread


def test_every_card_candidate_on_the_cpu_and_dispatch():
    q, k, v = (torch.tensor(a) for a in _inputs(2, 6, 2, 33, DH, seed=3))
    want = ref.flash_decode_plain(q, k, v, 20)
    before = fd_kernel.flash_decode_cuda.launches
    for cfg in ops.CANDIDATES + (ops.FDConfig(7),):
        assert torch.equal(ops.flash_decode(q, k, v, torch.tensor(20, dtype=torch.int32), cfg),
                           want)
    assert fd_kernel.flash_decode_cuda.launches == before
    with pytest.raises(ValueError, match="positive"):
        ops.flash_decode(q, k, v, 20, ops.FDConfig(0))
    with pytest.raises(ValueError, match="not instantiated"):
        fd_kernel.flash_decode_cuda(q, k, v, 20, 7)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fd_kernel.flash_decode_cuda(q, k, v, 20, ops.WORST_CASE.bk)
    assert ops.WORST_CASE == ops.CANDIDATES[0] == ops.FDConfig()
    assert fd_kernel.n_splits(0, 33, 256) == 1 and fd_kernel.n_splits(32768, 32768, 256) == 128


def _source_constant(name):
    src = (Path(fd_kernel.__file__).parents[2] / "csrc" / "flash_decode.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_cost_model_tile_follows_the_source():
    """FDConfig's shared memory, threads and registers describe the split
    pass of csrc/flash_decode.cu: the constants mirror the source, and the
    shared memory is its smem_bytes<DH, T>(): max(ring, merge) + p and
    rescale + (m, l), with ring = kWarps * kStages * 2 * kRows * DH *
    sizeof(T) and merge = kWarps * kMaxG * DH * 4."""
    for name, value in (("kWarps", fd_kernel.WARPS), ("kRows", fd_kernel.ROWS),
                        ("kStages", fd_kernel.STAGES), ("kMaxG", fd_kernel.MAX_GROUP)):
        assert _source_constant(name) == value, name
    assert fd_kernel.THREADS == 32 * fd_kernel.WARPS
    cfg = ops.WORST_CASE
    assert cfg.smem_bytes(128) == 66432          # smem_bytes<128, float>()
    assert cfg.smem_bytes(64) == 33664           # smem_bytes<64, float>()
    assert cfg.smem_bytes(128, 2) == 33664       # smem_bytes<128, __nv_bfloat16>()
    assert cfg.smem_bytes(64, 2) == 17280        # smem_bytes<64, __nv_bfloat16>(): merge > ring
    assert all(c.smem_bytes(128) == cfg.smem_bytes(128) for c in ops.CANDIDATES)
    assert cfg.threads(64) == cfg.threads(128) == 128
    assert cfg.registers(128) == 100 and cfg.registers(64) == 84
