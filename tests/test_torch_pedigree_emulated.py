"""K3's CUDA source, run on the CPU, against its plain version.

``csrc/pedigree_sampler.cu`` is compiled with g++ against ``cuda_emu.h``
(every GPU thread a fiber; warp collectives and named barriers switch
fibers) and launched through the wrapper's own ``_launch`` on CPU
tensors.  With pinned noise the kernel must give the plain version's
trace on a tetraploid family of 2 parents and 5 progeny over three loci,
at 1, 4 and 16 warps per block;
without noise its Philox draws must be keyed by global chain, so a block
launched in pieces with ``chain_offset`` gives the whole launch's trace,
and the plain version, drawing the same stream on the host, must give
the kernel's trace.
Skips where g++ is missing.
"""

import types

import numpy as np
import pytest
import torch

import emulated_cuda
from mchap_tpu_torch.ops import cuda_pedigree as K3
from mchap_tpu_torch.ops import nvcc_build

torch.set_num_threads(1)

SOURCE = nvcc_build.CSRC / "pedigree_sampler.cu"
WARPS = 4


@pytest.fixture(scope="module")
def emulated():
    """K3's library built for the host, in the wrapper's cache, launched
    with ``WARPS`` warps per block."""
    lib = emulated_cuda.build(SOURCE)
    if lib is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    mp = pytest.MonkeyPatch()
    mp.setattr(nvcc_build, "build_library", lambda name, *a, **k: lib)
    mp.setattr(K3, "_lib", None)
    mp.setattr(K3, "launch_warps", lambda *a: WARPS)
    mp.setattr(torch.cuda, "current_stream",
               lambda *a: types.SimpleNamespace(cuda_stream=None))
    yield
    mp.undo()


def _inputs(N=3, chains=2, S=7, P=4, R=8, H=5, seed=0):
    """Random reads against H haplotypes at N loci of a 2 + 5 family."""
    rng = np.random.default_rng(seed)
    parents = np.array([[-1, -1], [-1, -1]] + [[0, 1]] * (S - 2))
    plan = K3.Plan(np.full(S, P), parents, np.full((S, 2), P // 2), np.zeros((S, 2)),
                   np.full((S, 2), 0.01))
    rh = rng.uniform(-9.0, 0.0, size=(N, S, R, H)).astype(np.float32)
    counts = rng.integers(0, 3, size=(N, S, R)).astype(np.float32)
    freqs = rng.uniform(0.5, 1.0, size=(N, H))
    freqs /= freqs.sum(axis=1, keepdims=True)
    C = N * chains
    initial = rng.integers(0, H, size=(C, S, P)).astype(np.int32)
    tensors = [torch.from_numpy(x) for x in (
        rh, counts, freqs, np.full(N, H, np.int32),
        np.repeat(np.arange(N), chains).astype(np.int32), initial)]
    return tensors, plan


@pytest.mark.parametrize("warps", [1, 4, 16])
def test_kernel_matches_plain(emulated, monkeypatch, warps):
    """Equal at every block size: a sample's sums are taken in a fixed
    order whatever the warps per block."""
    monkeypatch.setattr(K3, "launch_warps", lambda *a: warps)
    (rh, counts, freqs, nv, prob, init), plan = _inputs()
    steps = 3
    noise = torch.rand((steps, plan.n_draws(rh.shape[-1]), prob.shape[0]),
                       generator=torch.Generator().manual_seed(1)).clamp_(min=1e-12)
    args = (rh, counts, freqs, nv, prob, init, plan)
    t_k = K3._launch(*args, n_steps=steps, seed=0, noise=noise)
    t_p = K3.pedigree_sampler_plain(*args, n_steps=steps, noise=noise)
    np.testing.assert_array_equal(t_k.numpy(), t_p.numpy())
    assert (t_k[:, 1:] != t_k[:, :-1]).any()  # the chains move


def test_chain_offset_keys_philox_by_global_chain(emulated):
    """Loci launched in pieces (1 + 2 of 3, each with its first chain as
    ``chain_offset``) draw what one launch of the block draws; at offset
    0 a piece replays chain 0's stream and differs."""
    (rh, counts, freqs, nv, prob, init), plan = _inputs(seed=2)
    kw = dict(n_steps=3, seed=(5 << 32) | 0x9E3779B9, noise=None)
    whole = K3._launch(rh, counts, freqs, nv, prob, init, plan, **kw)
    parts = []
    for lo, hi in [(0, 1), (1, 3)]:
        c0, c1 = 2 * lo, 2 * hi
        parts.append(K3._launch(
            rh[lo:hi].contiguous(), counts[lo:hi].contiguous(), freqs[lo:hi].contiguous(),
            nv[lo:hi].contiguous(), (prob[c0:c1] - lo).contiguous(),
            init[c0:c1].contiguous(), plan, chain_offset=c0, **kw))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())
    zero = K3._launch(rh[1:3].contiguous(), counts[1:3].contiguous(),
                      freqs[1:3].contiguous(), nv[1:3].contiguous(),
                      (prob[2:6] - 1).contiguous(), init[2:6].contiguous(), plan, **kw)
    assert (zero != whole[2:6]).any()


def test_live_draws_match_plain(emulated):
    """With no ``noise`` the kernel's Philox draws and the plain version's
    host copy of them (``cuda_pedigree.philox_step``) give the same
    trace, at chain offset 1000."""
    args, plan = _inputs(seed=3)
    kw = dict(n_steps=3, seed=(5 << 32) | 0x9E3779B9, noise=None, chain_offset=1000)
    t_k = K3._launch(*args, plan, **kw)
    t_p = K3.pedigree_sampler_plain(*args, plan, **kw)
    np.testing.assert_array_equal(t_k.numpy(), t_p.numpy())
    assert (t_k[:, 1:] != t_k[:, :-1]).any()
