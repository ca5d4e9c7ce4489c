"""Tests that need the card: they skip where torch sees no CUDA device.

Run them on a machine with one NVIDIA GPU and nvcc (no JAX needed):
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import itertools

import pytest
import torch

from mchap_tpu_torch.ops import cuda_denovo as K


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: builds and loads the kernel library")


@pytest.mark.cuda
def test_state_layout_mirror_matches_kernel(card):
    """``cuda_denovo.chain_state_layout`` (the refusal check's CPU-side
    mirror) agrees with the kernel's ``denovo_sampler_state_layout``,
    which sets the launch, in both K1 libraries."""
    for ladder in (False, True):
        lib = K.load_library(ladder=ladder)
        grid = itertools.product((1, 2, 4, 8, 9, 12), (16, 64, 2048, 4096, 16384),
                                 (2, 16, 48, 201), (1, 2, 4, 8))
        for P, R, NB, T in grid:
            mirror = K.chain_state_layout(P, R, NB, T)
            del mirror["slot"]
            assert K.state_layout(lib, P, R, NB, T) == mirror, (P, R, NB, T)


@pytest.mark.cuda
def test_denovo_route_kernel_matches_plain(card):
    """K4 on the card against its plain version on the same keyed draws:
    a prior with one problem at F = 0 over 3 rungs, identical genotypes
    and llks within 1e-9 (f64; only the order of the read sums differs)."""
    import numpy as np

    from mchap_tpu_torch.ops import assemble_mcmc as M
    from mchap_tpu_torch.ops import cuda_denovo_route as KR

    rng = np.random.default_rng(0)
    S, C, P, NB, R, A = 8, 4, 4, 6, 24, 2
    reads = np.full((S, R, NB, A), 0.05)
    for s in range(S):
        haps = rng.integers(0, A, (P, NB))
        np.put_along_axis(reads[s], haps[rng.integers(0, P, R)][:, :, None], 0.95, axis=2)
    dev = torch.device("cuda", 0)
    args = [torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, A, (S, C, P, NB)), np.log(reads), np.ones((S, R)),
        np.full((S, NB), A), np.full((S, NB), 1.0 / NB))]
    ib = torch.full((S,), 0.1, dtype=torch.float64, device=dev)
    ib[3] = 0.0
    kw = dict(n_steps=20, burn=5, inbreeding=ib)
    g_k, l_k = KR.denovo_route_sampler(7, 100, *args, (0.3, 0.6, 1.0), **kw)
    g_p, l_p = M.denovo_sampler(7, 100, *args, (0.3, 0.6, 1.0), **kw)
    assert torch.equal(g_k, g_p)
    assert (l_k - l_p).abs().max().item() <= 1e-9
