"""The port's flash attention vs the JAX reference, on the CPU.

The same numpy inputs go through the port's plain version
(``flash_attention_plain``, what a CPU tensor runs) and through the
reference's ``naive_attention`` and its Pallas kernel in interpret mode
(``ops.flash_attention(..., interpret=True)``), for causal, windowed,
ragged and non-causal masks at GQA groups 1 to 4 and 8, head widths 16 to
320. Tolerance: 2e-6 absolute on outputs of magnitude ≤ ~3 (float32 sums
in another order; the two JAX forms differ from each other by as much), at
head widths above 128 scaled by dh / 128 (the score is a sum of dh
products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops, ref

TOL = 2e-6

#: The reference's oracle compiled as one program per shape (op by op it
#: compiles each of its operations anew for every shape).
_naive = jax.jit(jref.naive_attention, static_argnames=("causal", "window"))

#: (b, sq, skv, h, hk, dh, causal, window, (bq, bk) of the reference kernel)
CASES = {
    "causal-g1": (2, 64, 64, 2, 2, 64, True, 0, (32, 32)),
    "window-ragged-g2": (1, 50, 50, 4, 2, 64, True, 16, (32, 32)),
    "noncausal-ragged-g3": (1, 40, 72, 3, 1, 128, False, 0, (128, 128)),
    "noncausal-ragged-dh80": (1, 45, 45, 2, 2, 80, False, 0, (32, 32)),
    "window-g2-dh320": (1, 40, 40, 4, 2, 320, True, 12, (32, 32)),
    "causal-ragged-g4-dh16": (2, 37, 37, 8, 2, 16, True, 0, (32, 32)),
    "noncausal-ragged-g8-dh112": (1, 45, 29, 8, 1, 112, False, 0, (32, 32)),
}


def _inputs(b, sq, skv, h, hk, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh), dtype=np.float32),
            rng.standard_normal((b, skv, hk, dh), dtype=np.float32),
            rng.standard_normal((b, skv, hk, dh), dtype=np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_reference_naive_and_interpret_kernel(case):
    b, sq, skv, h, hk, dh, causal, window, (bq, bk) = CASES[case]
    tol = TOL * max(1.0, dh / 128)
    q, k, v = _inputs(b, sq, skv, h, hk, dh)
    got = ref.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    causal=causal, window=window).numpy()
    naive = np.asarray(_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window))
    interp = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        config=jops.FAConfig(bq, bk), interpret=True))
    assert got.shape == naive.shape == (b, sq, h, dh)
    np.testing.assert_allclose(got, naive, rtol=0, atol=tol)
    np.testing.assert_allclose(got, interp, rtol=0, atol=tol)
    port_naive = ref.naive_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                     causal=causal, window=window).numpy()
    np.testing.assert_allclose(port_naive, naive, rtol=0, atol=tol)


def test_fully_masked_rows_give_zero():
    """Rows that see no key (here: a window that ends before the keys do)
    are 0 in the kernel's function, as in the Pallas kernel; the naive
    oracle spreads them evenly instead."""
    q, k, v = _inputs(1, 12, 4, 2, 1, 64, seed=1)
    got = ref.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    causal=True, window=3).numpy()
    interp = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=3,
        config=jops.FAConfig(128, 128), interpret=True))
    assert np.all(got[:, 6:] == 0.0)
    np.testing.assert_allclose(got, interp, rtol=0, atol=TOL)


def test_cpu_dispatch_runs_plain_and_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 33, 33, 4, 2, 64, seed=2))
    before = fa_kernel.flash_attention_cuda.launches
    outs = [ops.flash_attention(q, k, v, causal=True, config=c)
            for c in ops.CANDIDATES + (ops.FAConfig(16, 64),)]
    for out in outs[1:]:
        assert torch.equal(outs[0], out)                 # padding never changes results
    assert torch.equal(outs[0], ref.flash_attention_plain(q, k, v, causal=True))
    assert fa_kernel.flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="not instantiated"):
        fa_kernel.flash_attention_cuda(q, k, v, causal=True, tile=(128, 128))
    with pytest.raises(ValueError, match="positive"):
        ops.flash_attention(q, k, v, config=ops.FAConfig(0, 128))
    assert ops.WORST_CASE == ops.CANDIDATES[0] == ops.FAConfig()
    assert [(c.bq, c.bk) for c in ops.CANDIDATES] == list(fa_kernel.TILES)
    assert min(ops.CANDIDATES, key=lambda c: c.bq * c.bk) == ops.WORST_CASE


def test_tiles_by_head_width_fit_a_block():
    """Each head width's instantiated tiles fit a block's shared memory and
    pass the cost model's gate; the tiles of widths up to 128 that are not
    instantiated at 256 or 320 do not fit; the worst case at each width is
    its smallest tile, and the wrapper refuses a tile not instantiated at
    q's width before it looks at the device."""
    from repro_torch.core.altune import costmodel as cm

    assert fa_kernel.HEAD_DIMS == (16, 32, 64, 80, 112, 128, 256, 320)
    for dh in fa_kernel.HEAD_DIMS:
        cands = ops.candidates(dh)
        assert [(c.bq, c.bk) for c in cands] == list(fa_kernel.tiles(dh))
        assert ops.worst_case(dh) == min(cands, key=lambda c: c.bq * c.bk) == cands[0]
        for c in cands:
            assert c.smem_bytes(dh) <= cm.SMEM_PER_BLOCK
            assert cm.gate(c.smem_bytes(dh), c.threads(dh), c.registers(dh))[0]
        for c in set(ops.CANDIDATES) - set(cands):
            ok, note = cm.gate(c.smem_bytes(dh), c.threads(dh), c.registers(dh))
            assert not ok and "shared memory" in note
    assert ops.worst_case(256) == ops.FAConfig(64, 64) and ops.worst_case(320) == ops.FAConfig(32, 64)
    assert ops.FAConfig(64, 64).smem_bytes(320) == 263_168 > cm.SMEM_PER_BLOCK
    assert ops.worst_case(96) == ops.WORST_CASE  # a width the kernel does not take
    assert ops.FAConfig(64, 64).threads(256) == 256 and ops.FAConfig(64, 64).threads(128) == 128
    q = torch.zeros((1, 8, 1, 320))
    with pytest.raises(ValueError, match="not instantiated at dh 320"):
        fa_kernel.flash_attention_cuda(q, q, q, tile=(64, 64))
    with pytest.raises(ValueError, match="takes dh in"):
        fa_kernel.flash_attention_cuda(*(torch.zeros((1, 8, 1, 96)),) * 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention_cuda(q, q, q)
