"""K0, one mutation sweep: the port's plain version against the JAX kernel.

``mutation_sweep`` on CPU tensors runs ``mutation_sweep_plain`` (the plain
version of the CUDA entry ``mutation_sweep_launch``).  With every uniform
pinned at 1e-12 it must reproduce ``pallas_mutation_sweep(interpret=True)``,
whose interpreter PRNG gives 1e-12 for every draw: genotypes identical,
``rh`` and llk within 1e-4 (both add in f32, in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mchap_tpu.ops.pallas_denovo import pallas_mutation_sweep
from mchap_tpu_torch.ops.cuda_denovo import mutation_sweep

torch.set_num_threads(1)

NB, R, C = 8, 16, 128


def _case(P, A, seed):
    rng = np.random.default_rng(seed)
    lr = np.log(rng.dirichlet(np.ones(A), size=(R, NB, C)).astype(np.float32))
    lr = np.ascontiguousarray(lr.transpose(0, 1, 3, 2))  # [R, NB, A, C]
    nall = np.full(NB, A, np.int32)
    nall[2] = 1
    if A > 2:
        nall[5] = A - 1
    g = rng.integers(0, nall[None, :, None], size=(P, NB, C))
    onehot = np.eye(A, dtype=np.float32)[g].transpose(0, 1, 3, 2)  # [P, NB, A, C]
    counts = rng.integers(1, 3, size=(R, C)).astype(np.float32)
    # the chains' current llk, recomputed from the genotype in f64
    rows = np.take_along_axis(
        lr.astype(np.float64)[None], g[:, None, :, None, :], axis=3
    )[:, :, :, 0].sum(axis=2)  # [P, R, C]
    m = rows.max(axis=0)
    llk = (counts * (m + np.log(np.exp(rows - m).sum(axis=0)) - np.log(P))).sum(axis=0)
    return nall, lr, counts, np.ascontiguousarray(onehot), llk.astype(np.float32)


@pytest.mark.parametrize("temp", [1.0, 0.5])
@pytest.mark.parametrize("A", [2, 4])
@pytest.mark.parametrize("P", [2, 4])
def test_k0_plain_matches_pallas(P, A, temp):
    nall, lr, counts, onehot, llk = _case(P, A, seed=10 * P + A + int(temp * 4))
    want_g, want_rh, want_llk = pallas_mutation_sweep(
        jnp.int32(5), jnp.asarray(nall), jnp.asarray(lr), jnp.asarray(counts),
        jnp.asarray(onehot), jnp.asarray(llk), jnp.float32(temp), interpret=True,
    )
    got_g, got_rh, got_llk = mutation_sweep(
        5, *(torch.from_numpy(x) for x in (nall, lr, counts, onehot, llk)), temp,
        noise=torch.full((P * NB, C), 1e-12),
    )
    want_g = np.asarray(want_g)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_allclose(got_rh.numpy(), np.asarray(want_rh), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_llk.numpy(), np.asarray(want_llk), rtol=0, atol=1e-4)
    # the pinned sweep does move genotypes, so the comparison is not vacuous
    assert (want_g != onehot).any()
    # sites with a single allele never move
    np.testing.assert_array_equal(want_g[:, 2], onehot[:, 2])


def test_k0_cpu_stream_is_seeded():
    nall, lr, counts, onehot, llk = _case(4, 2, seed=1)
    args = (torch.from_numpy(x) for x in (nall, lr, counts, onehot, llk))
    args = list(args)
    a = mutation_sweep(9, *args, 0.5)
    b = mutation_sweep(9, *args, 0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].shape == (4, NB, 2, C) and a[1].shape == (4, R, C) and a[2].shape == (C,)
