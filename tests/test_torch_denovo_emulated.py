"""K1's CUDA source, run on the CPU, against its plain version.

``csrc/denovo_sampler.cu`` is compiled with g++ against ``cuda_emu.h``
(every GPU thread a fiber; warp collectives switch fibers), both of its
builds (flat with K0, and ``-DK1_LADDER``), and launched through the
wrapper's own ``_launch`` on CPU tensors.  With pinned noise each case
must give the plain version's packed trace on every chain and its llks
within 1e-4 (the host's expf/logf against torch's): ploidy 1 to 12, A 2
to 4, stages 1 to 3, ladders and the prior, near-zero noise that takes
nearly every move, a state too deep for shared memory, and K0.  Without
noise the kernel draws its own Philox stream and the plain version
draws the same one on the host (``utils.philox.keyed_uniforms``), so
the two must agree there too, at a non-zero ``chain_offset``.  About
30 s, the two g++ builds included.  Skips where g++ is missing.
"""

import types

import numpy as np
import pytest
import torch

import emulated_cuda
from mchap_tpu_torch.ops import cuda_denovo as K
from mchap_tpu_torch.ops import nvcc_build
from test_torch_fixtures import k1_case

torch.set_num_threads(1)

SOURCE = nvcc_build.CSRC / "denovo_sampler.cu"


@pytest.fixture(scope="module")
def emulated(monkeypatch_module):
    """K1's two libraries built for the host, in the wrapper's cache."""
    libs = {}

    def build_library(name, source_name=None, defines=()):
        lib = emulated_cuda.build(SOURCE, defines)
        if lib is None:
            pytest.skip("g++ is needed to build the kernel source for the host")
        return lib

    monkeypatch_module.setattr(nvcc_build, "build_library", build_library)
    monkeypatch_module.setattr(K, "_libs", libs)
    monkeypatch_module.setattr(
        torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=None)
    )
    return libs


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _inputs(P, NB, A, R, C, seed, n_distinct=None):
    rng = np.random.default_rng(seed)
    S = 2
    lr = np.zeros((S, NB, A, R), np.float32)
    for s in range(S):
        haps = rng.integers(0, A, size=(n_distinct or P, NB))[np.arange(P) % (n_distinct or P)]
        probs = np.full((R, NB, A), 0.05 / (A - 1), np.float32)
        calls = haps[rng.integers(0, P, R)]  # [R, NB]
        np.put_along_axis(probs, calls[:, :, None], 0.95, axis=2)
        lr[s] = np.log(probs).transpose(1, 2, 0)
    g0 = rng.integers(0, A, size=(P, NB, C)).astype(np.int32)
    return [torch.from_numpy(x) for x in (
        lr, np.ones((S, R), np.float32), g0, np.full((S, NB), A, np.int32),
        np.full(S, 0.3, np.float32), (np.arange(C) % S).astype(np.int32))]


def _compare(args, steps, noise_scale=1.0, temps=None, alpha=None, stage=3, seed=1):
    P, NB, C = args[2].shape
    D = K.draw_layout(P, NB, 1 if temps is None else len(temps))["D"]
    noise = torch.rand((steps, D, C), generator=torch.Generator().manual_seed(seed))
    kw = dict(n_steps=steps, p_recomb=0.5, p_partial=0.5, p_full=1.0, refresh=4,
              stage=stage, seed=0, noise=(noise * noise_scale).clamp_(min=1e-12),
              temps=K.ladder(temps), alpha=alpha)
    t_k, l_k = K._launch(*args, **kw)
    t_p, l_p = K.denovo_sampler_plain(*args, **kw)
    np.testing.assert_array_equal(t_k.numpy(), t_p.numpy())
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-4)
    # the chains move, so the comparison is not vacuous
    base = K.next_pow2(max(args[0].shape[2], 2))
    start = sum(args[2][h].long() * base ** h for h in range(P))  # [NB, C]
    assert (t_k.long() != torch.cat([start[None], t_k[:-1].long()])).any()


@pytest.mark.parametrize("P, NB, A, R", [
    (1, 8, 2, 64), (2, 8, 3, 50), (3, 40, 2, 64), (4, 48, 3, 64), (6, 10, 4, 40),
    (8, 12, 2, 64), (9, 6, 2, 64), (12, 6, 3, 33),
])
def test_flat_kernel_matches_plain(emulated, P, NB, A, R):
    _compare(_inputs(P, NB, A, R, 8, seed=P), 6)


@pytest.mark.parametrize("stage", [1, 2])
def test_flat_kernel_matches_plain_early_stages(emulated, stage):
    _compare(_inputs(4, 16, 2, 64, 8, seed=stage), 6, stage=stage)


@pytest.mark.parametrize("P, A", [(4, 2), (12, 2), (6, 4)])
def test_kernel_matches_plain_taking_nearly_every_move(emulated, P, A):
    """Draws near 0 accept nearly every proposal: every accepted
    mutation restarts a run of sites, every structural step applies."""
    args = [torch.from_numpy(x) for x in k1_case(P, A, seed=P + A)]
    _compare(args, 4, noise_scale=1e-3)


@pytest.mark.parametrize("P, temps, prior", [
    (4, [0.3, 0.6, 1.0], True), (2, [0.2 + 0.1 * i for i in range(7)] + [1.0], True),
    (9, [0.5, 1.0], False), (4, None, True),
])
def test_ladder_kernel_matches_plain(emulated, P, temps, prior):
    args = _inputs(P, 8, 2, 64, 4, seed=10 + P, n_distinct=2)
    alpha = torch.tensor([0.05, 0.5]) if prior else None
    _compare(args, 5, temps=temps, alpha=alpha)


@pytest.mark.parametrize("P, R, temps", [(4, 7300, None), (12, 2500, None), (4, 3700, [0.5, 1.0])])
def test_kernel_state_in_scratch_matches_plain(emulated, P, R, temps):
    """A chain whose state exceeds a block's shared memory keeps its
    slots in the wrapper's scratch buffer."""
    assert not K.chain_state_layout(P, R, 4, 1 if temps is None else len(temps))["in_smem"]
    _compare(_inputs(P, 4, 2, R, 2, seed=R), 2, temps=temps)


@pytest.mark.parametrize("P, A", [(4, 2), (6, 3)])
def test_mutation_sweep_kernel_matches_plain(emulated, P, A):
    """K0, the second entry of the source."""
    rng = np.random.default_rng(P)
    R, NB, C = 64, 12, 6
    args = _inputs(P, NB, A, R, C, seed=20 + P)
    lr = args[0][args[5].long()].permute(3, 1, 2, 0).contiguous()  # [R, NB, A, C]
    g = args[2]
    onehot = torch.nn.functional.one_hot(g.long(), A).permute(0, 1, 3, 2).float().contiguous()
    x = (torch.full((NB,), A, dtype=torch.int32), lr, torch.ones((R, C)), onehot,
         torch.from_numpy(rng.normal(size=C).astype(np.float32)))
    noise = torch.rand((P * NB, C), generator=torch.Generator().manual_seed(2))
    g_k, rh_k, llk_k = K._launch_mutation(0, *x, 0.5, noise=noise)
    g_p, rh_p, llk_p = K.mutation_sweep_plain(0, *x, 0.5, noise=noise)
    np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
    np.testing.assert_allclose(rh_k.numpy(), rh_p.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(llk_k.numpy(), llk_p.numpy(), rtol=0, atol=1e-4)


SEED = (5 << 32) | 0x9E3779B9  # both halves of the seed in use


@pytest.mark.parametrize("temps, prior", [(None, False), ([0.3, 0.6, 1.0], True)])
def test_live_draws_match_plain(emulated, temps, prior):
    """K1 flat, and with a ladder and the prior, with no ``noise``: the
    kernel's Philox draws and the plain version's host copy of them give
    the same traces, at chain offset 1000."""
    args = _inputs(4, 8, 2, 64, 8, seed=40, n_distinct=2)
    kw = dict(n_steps=5, p_recomb=0.5, p_partial=0.5, p_full=1.0, refresh=4, stage=3,
              seed=SEED, noise=None, temps=K.ladder(temps),
              alpha=torch.tensor([0.05, 0.5]) if prior else None)
    t_k, l_k = K._launch(*args, chain_offset=1000, **kw)
    t_p, l_p = K.denovo_sampler_plain(*args, chain_offset=1000, **kw)
    np.testing.assert_array_equal(t_k.numpy(), t_p.numpy())
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-4)
    assert (t_k[1:] != t_k[:-1]).any()


def test_mutation_sweep_live_draws_match_plain(emulated):
    """K0 with no ``noise``: its Philox draws (K1's stream at step 0,
    chains from 0) are the plain version's."""
    R, NB, A, C, P = 64, 12, 2, 6, 4
    args = _inputs(P, NB, A, R, C, seed=41)
    lr = args[0][args[5].long()].permute(3, 1, 2, 0).contiguous()
    onehot = torch.nn.functional.one_hot(args[2].long(), A).permute(0, 1, 3, 2)
    x = (torch.full((NB,), A, dtype=torch.int32), lr, torch.ones((R, C)),
         onehot.float().contiguous(), torch.full((C,), -1e3))  # an llk below every move's
    g_k, rh_k, llk_k = K._launch_mutation(SEED, *x, 0.5, noise=None)
    g_p, rh_p, llk_p = K.mutation_sweep_plain(SEED, *x, 0.5, noise=None)
    np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
    np.testing.assert_allclose(llk_k.numpy(), llk_p.numpy(), rtol=0, atol=1e-4)
    assert not torch.equal(g_k, x[3])


def _launch_chains(args, lo, hi, offset, kw):
    """K1 on chains [lo, hi) of ``args`` alone, keyed from ``offset``."""
    lr, counts, g0, nall, pbreak, problem = args
    return K._launch(lr, counts, g0[:, :, lo:hi].contiguous(), nall, pbreak,
                     problem[lo:hi].contiguous(), chain_offset=offset, **kw)


@pytest.mark.parametrize("temps, prior", [(None, False), ([0.5, 1.0], True)])
def test_chain_offset_keys_philox_by_global_chain(emulated, temps, prior):
    """A block's chains launched in three uneven pieces, each with its
    first chain's index as ``chain_offset``, draw what one launch of the
    whole block draws: traces and llks identical.  At offset 0 a piece
    replays chain 0's stream instead, and differs."""
    args = _inputs(4, 8, 2, 64, 8, seed=31, n_distinct=2)
    kw = dict(n_steps=5, p_recomb=0.5, p_partial=0.5, p_full=1.0, refresh=4, stage=3,
              seed=(5 << 32) | 0x9E3779B9, noise=None, temps=K.ladder(temps),
              alpha=torch.tensor([0.05, 0.5]) if prior else None)
    t_all, l_all = _launch_chains(args, 0, 8, 0, kw)
    pieces = [_launch_chains(args, lo, hi, lo, kw) for lo, hi in [(0, 3), (3, 6), (6, 8)]]
    np.testing.assert_array_equal(torch.cat([t for t, _ in pieces], dim=2).numpy(),
                                  t_all.numpy())
    np.testing.assert_array_equal(torch.cat([l for _, l in pieces], dim=1).numpy(),
                                  l_all.numpy())
    t_zero, _ = _launch_chains(args, 3, 6, 0, kw)
    assert (t_zero != t_all[:, :, 3:6]).any()
