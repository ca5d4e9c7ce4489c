"""K2's CUDA source, run on the CPU, against its plain version.

``csrc/calling_sampler.cu`` is compiled with g++ against ``cuda_emu.h``
(every GPU thread a fiber; warp collectives switch fibers) and launched
through the wrapper's own ``_launch`` on CPU tensors.  With pinned noise
each case must give the plain version's alleles on every chain and its
llks within 1e-4 (the host's logf against torch's): ploidy 1 to 8;
panels of 3, 5, 16 and 40 (over 32 lanes) haplotypes; 16 to 64 reads,
33 of them (a chain's state an odd number of floats); per-problem
``n_valid`` with MIN_LOG padding columns (so chains of one launch take
different read groups, some past the last read, and lanes with one
batch of reads or many); and candidates tied or nearly tied.  Without
noise, the kernel's own Philox draws, made in the step before a slot or
in the slot, must be those of ``cuda_calling.philox_noise``, and the
plain version without noise, which draws them itself, must give the
kernel's chains.  A few
seconds, the g++ build included.  Skips where g++ is missing.
"""

import types

import numpy as np
import pytest
import torch

import emulated_cuda
from mchap_tpu_torch.ops import cuda_calling as KC
from mchap_tpu_torch.ops import nvcc_build
from mchap_tpu_torch.ops.likelihood import MIN_LOG

torch.set_num_threads(1)

SOURCE = nvcc_build.CSRC / "calling_sampler.cu"


@pytest.fixture(scope="module")
def emulated():
    """K2's library built for the host, in the wrapper's cache."""
    lib = emulated_cuda.build(SOURCE)
    if lib is None:
        pytest.skip("g++ is needed to build the kernel source for the host")
    mp = pytest.MonkeyPatch()
    mp.setattr(nvcc_build, "build_library", lambda name, *a, **k: lib)
    mp.setattr(KC, "_lib", None)
    mp.setattr(torch.cuda, "current_stream",
               lambda *a: types.SimpleNamespace(cuda_stream=None))
    yield
    mp.undo()


def _inputs(P, H, R, C, n_valid, seed, ties=False):
    """Random read x haplotype log-probabilities [S, R, H], with problem
    s keeping its first n_valid[s] columns (the rest MIN_LOG padding);
    with ``ties`` columns 1 and 2 repeat column 0 exactly and column 3
    repeats it up to 1e-3."""
    rng = np.random.default_rng(seed)
    S = len(n_valid)
    rh = rng.uniform(-12.0, 0.0, size=(S, R, H)).astype(np.float32)
    if ties:
        rh[:, :, 1] = rh[:, :, 2] = rh[:, :, 0]
        rh[:, :, 3] = rh[:, :, 0] - 1e-3
    for s, nv in enumerate(n_valid):
        rh[s, :, nv:] = MIN_LOG
    counts = rng.integers(0, 3, size=(S, R)).astype(np.float32)
    prob = (np.arange(C) % S).astype(np.int32)
    return [torch.from_numpy(x) for x in (rh, counts, np.asarray(n_valid, np.int32), prob)]


def _compare(args, P, steps, noise):
    kw = dict(n_steps=steps, ploidy=P, seed=0, noise=noise)
    g_k, l_k = KC._launch(*args, **kw)
    g_p, l_p = KC.calling_sampler_plain(*args, **kw)
    np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-4)
    assert (g_k.long() < args[2][args[3].long()].long()[None, None]).all()
    return g_k


@pytest.mark.parametrize("P, H, R, n_valid", [
    (1, 3, 16, (3, 2, 1)),
    (4, 16, 64, (16, 13, 7, 2)),
    (4, 40, 40, (40, 33, 32, 5)),
    (8, 3, 40, (3, 3, 2)),
    (8, 16, 16, (16, 9)),
    (4, 3, 64, (3,)),
    (3, 5, 33, (5, 4)),  # (P+3)*R odd: each chain's state rounded to whole pairs
    (2, 3, 16, (1, 3)),  # block 0's first chain has 32 read groups, 16 of them empty
])
def test_kernel_matches_plain(emulated, P, H, R, n_valid):
    """Alleles equal, llks close; and the kernel's shared memory per chain
    is the wrapper's mirror of it."""
    assert KC.load_library().calling_sampler_smem_bytes(P, R) == KC.smem_bytes(P, R)
    steps, C = 4, 2 * len(n_valid)
    args = _inputs(P, H, R, C, n_valid, seed=P * H + R)
    gen = torch.Generator().manual_seed(R)
    noise = torch.rand((steps, P, H, C), generator=gen).clamp_(min=1e-12)
    g = _compare(args, P, steps, noise)
    # the chains move, so the comparison is not vacuous
    assert (g[1:] != g[:-1]).any() or (g[0] != 0).any()


@pytest.mark.parametrize("constant_noise", [True, False])
def test_kernel_matches_plain_tied_candidates(emulated, constant_noise):
    """Columns 0-2 equal and column 3 within 1e-3 of them: with constant
    noise every score of the three ties exactly, and the lowest allele
    must win in both versions."""
    P, H, R, steps, C = 4, 6, 40, 3, 4
    args = _inputs(P, H, R, C, (6, 5), seed=9, ties=True)
    if constant_noise:
        noise = torch.full((steps, P, H, C), 0.5)
    else:
        gen = torch.Generator().manual_seed(3)
        noise = torch.rand((steps, P, H, C), generator=gen).clamp_(min=1e-12)
    g = _compare(args, P, steps, noise)
    assert not ((g == 1) | (g == 2)).any() if constant_noise else True


@pytest.mark.parametrize("P, H, n_valid", [
    (4, 16, (16, 7)),  # every slot's Philox calls made during the step before
    (4, 40, (40, 33)),  # P * ceil(n_valid / 4) > 32: each slot's calls in the slot
    (8, 20, (20, 13)),  # in the slot for n_valid 20, the step before for 13
])
def test_kernel_philox_matches_host_stream(emulated, P, H, n_valid):
    """With no ``noise`` the kernel draws from its own Philox stream, in
    the step before or in the slot as the panel's width decides; both
    must give the draws ``philox_noise`` makes on the host, so the plain
    version fed those gives the kernel's chains."""
    steps, C, R = 4, 2 * len(n_valid), 24
    seed = (5 << 32) | 0x9E3779B9  # both halves of the seed in use
    args = _inputs(P, H, R, C, n_valid, seed=P + H)
    g_k, l_k = KC._launch(*args, n_steps=steps, ploidy=P, seed=seed, noise=None)
    noise = KC.philox_noise(seed, steps, P, H, C)
    g_p, l_p = KC.calling_sampler_plain(*args, n_steps=steps, ploidy=P, noise=noise)
    np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-4)
    assert (g_k[1:] != g_k[:-1]).any()


def test_live_draws_match_plain(emulated):
    """Kernel and plain version both with no ``noise``, at chain offset
    1000: the plain version's own draws (``philox_step``) are the
    kernel's."""
    P, H, R, steps, C, seed = 4, 16, 24, 4, 8, (5 << 32) | 0x9E3779B9
    args = _inputs(P, H, R, C, (16, 7), seed=7)
    kw = dict(n_steps=steps, ploidy=P, seed=seed, noise=None, chain_offset=1000)
    g_k, l_k = KC._launch(*args, **kw)
    g_p, l_p = KC.calling_sampler_plain(*args, **kw)
    np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-4)
    assert (g_k[1:] != g_k[:-1]).any()


def test_chain_offset_keys_philox_by_global_chain(emulated):
    """A block's chains launched in three uneven pieces, each with its
    first chain's index as ``chain_offset``, draw what one launch of the
    whole block draws; ``philox_noise`` with the same offset gives a
    piece's draws on the host."""
    P, H, R, steps, C, seed = 4, 16, 24, 4, 8, (5 << 32) | 0x9E3779B9
    rh, counts, nv, prob = _inputs(P, H, R, C, (16, 7), seed=4)
    kw = dict(n_steps=steps, ploidy=P, seed=seed, noise=None)
    g_all, l_all = KC._launch(rh, counts, nv, prob, **kw)
    for lo, hi in [(0, 3), (3, 6), (6, 8)]:
        g, l = KC._launch(rh, counts, nv, prob[lo:hi].contiguous(), chain_offset=lo, **kw)
        np.testing.assert_array_equal(g.numpy(), g_all[:, :, lo:hi].numpy())
        np.testing.assert_array_equal(l.numpy(), l_all[:, lo:hi].numpy())
        noise = KC.philox_noise(seed, steps, P, H, hi - lo, chain_offset=lo)
        np.testing.assert_array_equal(
            noise.numpy(), KC.philox_noise(seed, steps, P, H, C)[..., lo:hi].numpy())
    g_zero, _ = KC._launch(rh, counts, nv, prob[3:6].contiguous(), **kw)
    assert (g_zero != g_all[:, :, 3:6]).any()


@pytest.mark.parametrize("offset", [2 ** 20, 2 ** 31 - 1 - 8])
def test_large_chain_offset(emulated, offset):
    """At an offset whose per-chain bases lie far before their arrays (up
    to the largest the wrapper takes, where c nears 2**31), the kernel's
    Philox draws are still ``philox_noise``'s at that offset, with pinned
    noise and without; one chain past that limit is refused."""
    P, H, R, steps, C, seed = 4, 16, 24, 3, 8, (5 << 32) | 0x9E3779B9
    args = _inputs(P, H, R, C, (16, 7), seed=6)
    noise = KC.philox_noise(seed, steps, P, H, C, chain_offset=offset)
    g_p, l_p = KC.calling_sampler_plain(*args, n_steps=steps, ploidy=P, noise=noise)
    for pinned in (None, noise):
        g_k, l_k = KC._launch(*args, n_steps=steps, ploidy=P, seed=seed, noise=pinned,
                              chain_offset=offset)
        np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
        np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="chain_offset"):
        KC.calling_sampler(*args, n_steps=steps, ploidy=P, seed=seed,
                           chain_offset=2 ** 31 - C)
