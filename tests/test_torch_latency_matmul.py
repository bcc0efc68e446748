"""The port's latency-tuned matmul vs the JAX reference, on the CPU.

The same numpy inputs go through the port's plain version
(``ref.matmul_plain``, what a CPU tensor runs), the reference's oracle
``ref.matmul`` and its Pallas kernel in interpret mode (one tiny shape).
Tolerances: 1e-5 in float32 (float32 sums in another order), 2e-2 in
bfloat16 (the result is rounded to bfloat16), as the reference's own
kernel tests state them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.latency_matmul import ops as jops
from repro.kernels.latency_matmul import ref as jref
from repro_torch.kernels.latency_matmul import kernel as mm_kernel
from repro_torch.kernels.latency_matmul import ops, ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_jref = jax.jit(jref.matmul)


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48, 40), (37, 130, 5)])
def test_plain_matches_reference_oracle(shape, dtype):
    x, y = _inputs(*shape)
    got = ref.matmul_plain(torch.tensor(x).to(getattr(torch, dtype)),
                           torch.tensor(y).to(getattr(torch, dtype)))
    want = _jref(jnp.asarray(x).astype(dtype), jnp.asarray(y).astype(dtype))
    assert str(got.dtype).endswith(dtype) and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_matches_interpret_kernel():
    """Ragged (40, 24) @ (24, 20): the reference pads to its (32, 32, 32)
    blocks, the port takes the shape as it is."""
    x, y = _inputs(40, 24, 20, seed=1)
    got = ops.matmul(torch.tensor(x), torch.tensor(y), ops.WORST_CASE).numpy()
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(y), jops.MMConfig(32, 32, 32),
                                  interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("shape", [(1, 1, 1), (100, 300, 70), (65, 17, 129)])
def test_ragged_shapes_through_ops_on_every_candidate(shape):
    x, y = (torch.tensor(a) for a in _inputs(*shape, seed=2))
    want = ref.matmul_plain(x, y)
    before = mm_kernel.matmul_cuda.launches
    for cfg in ops.CANDIDATES + (ops.MMConfig(512, 512, 1024),):
        got = ops.matmul(x, y, cfg)
        assert got.shape == (shape[0], shape[2]) and torch.equal(got, want)
    assert mm_kernel.matmul_cuda.launches == before


def test_dispatch_and_refusals():
    x, y = (torch.tensor(a) for a in _inputs(8, 8, 8))
    with pytest.raises(ValueError, match="positive"):
        ops.matmul(x, y, ops.MMConfig(0, 64, 16))
    with pytest.raises(ValueError, match="not instantiated"):
        mm_kernel.matmul_cuda(x, y, 256, 256, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mm_kernel.matmul_cuda(x, y, *dataclasses.astuple(ops.WORST_CASE))
    assert ops.WORST_CASE == ops.CANDIDATES[0] == ops.MMConfig()
    assert all(dataclasses.astuple(c) in mm_kernel.TILES for c in ops.CANDIDATES)
    assert min(ops.CANDIDATES, key=lambda c: c.bm * c.bn * c.bk) == ops.WORST_CASE
