"""K3's wave plan (``Plan.waves``) on the CPU.

The kernel updates the members of a wave at once, one warp each.  That
gives the serial order's chain only if no member's conditional reads
another member's genotype; these tests check the partition on every
pedigree ``chip_smoke.py`` runs, and show with the plain version under
pinned noise that the order inside a wave does not change the trace,
while an order across a wave boundary does.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mchap_tpu_torch.ops import cuda_pedigree as K3
from mchap_tpu_torch.ops.pedigree_mcmc import markov_blankets

torch.set_num_threads(1)

PEDIGREES = {
    "bi-parental": (cs.BIPARENTAL, None, None),
    "selfed": (cs.SELFED, None, None),
    "backcross": (cs.BACKCROSS, None, None),
    "mixed ploidy": (cs.MIXED, cs.MIXED_PLOIDY, cs.MIXED_TAU),
    "three generations": (cs.THREE_GEN, None, None),
}


def _plan(name):
    parents, ploidy, tau = PEDIGREES[name]
    return cs._pedigree_plan(parents, ploidy, tau)


@pytest.mark.parametrize("name", list(PEDIGREES))
def test_waves_partition_the_update_order(name):
    plan = _plan(name)
    assert [s for w in plan.waves for s in w] == list(plan.order)
    blanket = markov_blankets(plan.parents)
    for i, wave in enumerate(plan.waves):
        for a in wave:
            assert not any(b in blanket[a] for b in wave if b != a), (wave, a)
        if i + 1 < len(plan.waves):  # maximal: the next sample meets this wave
            assert any(m in blanket[plan.waves[i + 1][0]] for m in wave)
    flat, offsets = plan.ints()
    wave_ptr = flat[offsets[-1]:offsets[-1] + len(plan.waves) + 1]
    assert list(wave_ptr) == list(np.cumsum([0] + [len(w) for w in plan.waves]))


def test_biparental_family_waves():
    assert _plan("bi-parental").waves == [[0], [1], list(range(2, 22))]


def _trace(name, order, seed=0, chains=3, steps=3, H=5):
    parents, ploidy, tau = PEDIGREES[name]
    rng = np.random.default_rng(seed)
    rh, counts, freqs, nv = cs._pedigree_inputs(
        rng, parents, 1, torch.device("cpu"), ploidy, tau, H=H, NB=3, R=8
    )
    plan = _plan(name)
    plan.order = list(order)
    S, maxp = plan.n_samples, plan.max_ploidy
    init = rng.integers(0, H, (chains, S, maxp)).astype(np.int32)
    init[:, np.arange(maxp)[None, :] >= plan.ploidy[:, None]] = -1
    noise = rng.random((steps, plan.n_draws(H), chains)).astype(np.float32)
    return K3.pedigree_sampler_plain(
        rh, counts, freqs, nv, torch.zeros(chains, dtype=torch.int32),
        torch.from_numpy(init), plan, n_steps=steps,
        noise=torch.from_numpy(np.maximum(noise, 1e-12)),
    )


@pytest.mark.parametrize("name", list(PEDIGREES))
def test_order_inside_a_wave_leaves_the_trace(name):
    waves = _plan(name).waves
    rng = np.random.default_rng(1)
    want = _trace(name, [s for w in waves for s in w])
    reversed_ = [s for w in waves for s in w[::-1]]
    shuffled = [s for w in waves for s in rng.permutation(w)]
    assert torch.equal(_trace(name, reversed_), want)
    assert torch.equal(_trace(name, shuffled), want)


@pytest.mark.parametrize("name", ["bi-parental", "three generations"])
def test_order_across_waves_changes_the_trace(name):
    """The whole order reversed, which moves samples across wave
    boundaries, gives another chain."""
    waves = _plan(name).waves
    want = _trace(name, [s for w in waves for s in w])
    across = [s for w in waves for s in w][::-1]
    assert not torch.equal(_trace(name, across), want)


def test_warps_per_block():
    """16 warps while every chain has an SM (phase M's 128 chains, phase
    L's 40), halved down to 4 as chains outnumber SMs (M's 16,384), and
    halved further only while the shared memory does not fit."""
    def small(warps):
        return 1000 * warps

    assert K3.warps_per_block(40, 132, 16, small) == 16
    assert K3.warps_per_block(132, 132, 16, small) == 16
    assert K3.warps_per_block(200, 132, 16, small) == 8
    assert K3.warps_per_block(16384, 132, 16, small) == 4
    assert K3.warps_per_block(16384, 132, 8, small) == 4
    assert K3.warps_per_block(40, 132, 16, lambda w: 60_000 * w) == 2
    assert K3.warps_per_block(40, 132, 16, lambda w: 10 ** 9) == 1
