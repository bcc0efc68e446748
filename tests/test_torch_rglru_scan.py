"""The port's RG-LRU scan vs the JAX reference, on the CPU.

The port's plain version (``ref.rglru_scan_plain``, what a CPU tensor runs
and what the CUDA kernel is held to bitwise) carries the state in float32,
rounds ``a_t * h`` and ``+ b_t`` separately and writes each step in a's
dtype. So it must equal, bit for bit:

* the reference's ``ref.rglru_scan`` on float32 operands (the suite's
  ``conftest.py`` turns XLA's optimization passes off; with them on, XLA's
  CPU backend contracts ``a * h + b`` into one FMA and the two differ by an
  ulp);
* the float32-carry oracle of the reference's kernel tests, and its Pallas
  kernel in interpret mode, on bfloat16 operands.

The identity padding of the reference's ``ops`` (``a = 1``, ``b = 0``,
``h0 = 0``) leaves every real element unchanged, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ref as jref
from repro.kernels.rglru_scan.kernel import rglru_scan_tiled
from repro_torch.kernels.rglru_scan import kernel as sc_kernel
from repro_torch.kernels.rglru_scan import ops, ref


@jax.jit
def _fp32_carry_oracle(a, b, h0):
    """The reference kernel tests' oracle: float32 carry, each step cast to
    a.dtype (``tests/test_rglru_scan_kernel.py``)."""

    def step(h, ab):
        a_t, b_t = ab
        h = a_t.astype(jnp.float32) * h + b_t.astype(jnp.float32)
        return h, h.astype(a.dtype)

    _, hs = jax.lax.scan(step, h0.astype(jnp.float32), (a.swapaxes(0, 1), b.swapaxes(0, 1)))
    return hs.swapaxes(0, 1)


def _inputs(bsz, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (bsz, s, d)).astype(np.float32),
            rng.standard_normal((bsz, s, d), dtype=np.float32),
            rng.standard_normal((bsz, d), dtype=np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _jbits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def test_plain_bitwise_equals_reference_in_float32():
    a, b, h0 = _inputs(2, 50, 37)
    got = ref.rglru_scan_plain(torch.tensor(a), torch.tensor(b), torch.tensor(h0))
    want = jax.jit(jref.rglru_scan)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    assert np.array_equal(_bits(got), _jbits(want))


def test_plain_bitwise_equals_fp32_carry_oracle_and_interpret_kernel_in_bf16():
    a, b, h0 = (jnp.asarray(x).astype(jnp.bfloat16) for x in _inputs(2, 24, 16, seed=1))
    got = ref.rglru_scan_plain(*(torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
                                 for x in (a, b, h0)))
    oracle = _fp32_carry_oracle(a, b, h0)
    interp = rglru_scan_tiled(a, b, h0, bd=16, bs=8, interpret=True)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _jbits(oracle))
    assert np.array_equal(_bits(got), _jbits(interp))


def test_identity_padding_leaves_the_result_unchanged():
    a, b, h0 = (torch.tensor(x) for x in _inputs(3, 11, 7, seed=2))
    want = ref.rglru_scan_plain(a, b, h0)
    ps, pd = 5, 9
    ap = torch.nn.functional.pad(a, (0, pd, 0, ps), value=1.0)
    bp = torch.nn.functional.pad(b, (0, pd, 0, ps))
    hp = torch.nn.functional.pad(h0, (0, pd))
    got = ref.rglru_scan_plain(ap, bp, hp)[:, :11, :7]
    assert np.array_equal(_bits(got.contiguous()), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_card_candidate_on_the_cpu(dtype):
    a, b, h0 = (torch.tensor(x).to(dtype) for x in _inputs(2, 33, 19, seed=3))
    want = ref.rglru_scan_plain(a, b, h0)
    before = sc_kernel.rglru_scan_cuda.launches
    for cfg in ops.CANDIDATES + (ops.ScanConfig(256, 128),):
        assert np.array_equal(_bits(ops.rglru_scan(a, b, h0, cfg)), _bits(want))
    assert sc_kernel.rglru_scan_cuda.launches == before


def test_dispatch_and_refusals():
    a, b, h0 = (torch.tensor(x) for x in _inputs(1, 4, 4))
    with pytest.raises(ValueError, match="positive"):
        ops.rglru_scan(a, b, h0, ops.ScanConfig(0, 4))
    with pytest.raises(ValueError, match="not instantiated"):
        sc_kernel.rglru_scan_cuda(a, b, h0, 256, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc_kernel.rglru_scan_cuda(a, b, h0, ops.WORST_CASE.bd, ops.WORST_CASE.bs)
    assert ops.WORST_CASE == ops.CANDIDATES[0] == ops.ScanConfig()
    assert min(ops.CANDIDATES, key=lambda c: c.bd * c.bs) == ops.WORST_CASE
