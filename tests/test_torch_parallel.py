"""A block's problems spread over devices: ``mchap_tpu_torch/parallel/``.

The port's counterpart of ``tests/test_parallel.py``, on CPU "devices"
(a list that names the CPU more than once, as ``problem_devices`` takes).

- Kernel routes (K1, K2, K3's plain versions here) with every draw pinned
  at 1e-12, the JAX interpreter's value: sharded over 2 and 3 devices, on
  blocks that are no multiple of either, they give the unsharded run's
  genotypes and llks, and JAX's run sharded over a 2-device "lanes" mesh.
- The het-compaction trap: problems of different het widths, so that a
  shard compacting on its own would launch narrower; every shard must
  launch at the block's width.
- Torch routes, whose draws are keyed by each row's index in the whole
  block: sharded over 2 and 3 devices, on blocks of five problems, they
  give the unsharded run's traces bit for bit, and they stay within the
  existing exact-enumeration bounds.
- ``call-exact``'s block path sharded: byte-equal VCF.
- Pools against the host formulas and JAX's ``pooled_info_collectives``
  on a 2-device mesh; the sharded calling step and its pooled counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mchap_tpu.models import assemble as jax_assemble
from mchap_tpu.models import calling as jax_calling
from mchap_tpu.models import pedigree as jax_pedigree
from mchap_tpu.ops import exact as jax_exact
from mchap_tpu.ops.pallas_pedigree import make_plan
from mchap_tpu.parallel import mesh as jax_mesh
from mchap_tpu.parallel.pools import pooled_info_collectives, shard_pool_problems
from mchap_tpu.testing import simulate_reads
from mchap_tpu_torch.application.call_exact import exact_stats_sharded
from mchap_tpu_torch.models import assemble, calling, pedigree
from mchap_tpu_torch.ops import exact
from mchap_tpu_torch.ops.likelihood import MIN_LOG
from mchap_tpu_torch.parallel import mesh, pools, sharding
from mchap_tpu_torch.utils import fallback
from test_torch_assemble_model import _wrapper_case

torch.set_num_threads(1)

CPU = torch.device("cpu")
PINNED = 1e-12  # the JAX interpreter's value of every uniform draw
SHARDS = {"2": [CPU] * 2, "3": [CPU] * 3}


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("lanes",))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_problem_devices(monkeypatch):
    """"auto" takes every card for a block of 2 or more, on a card only,
    unless MCHAP_SHARD=0; an explicit list is kept, repeats and all."""
    assert sharding.problem_devices(10, "auto", CPU) is None
    assert sharding.problem_devices(10, None, CPU) is None
    assert sharding.problem_devices(1, ["cpu", "cpu"], CPU) == [CPU, CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda", 0)
    want = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert sharding.problem_devices(10, "auto", cuda) == want
    assert sharding.problem_devices(1, "auto", cuda) is None
    assert sharding.problem_devices(10, "auto", CPU) is None
    monkeypatch.setenv("MCHAP_SHARD", "0")
    assert sharding.problem_devices(10, "auto", cuda) is None
    with pytest.raises(ValueError):
        sharding.problem_devices(10, "all", cuda)


def test_split_and_shard_problems():
    """Contiguous, near-equal, unpadded blocks; empty shards dropped."""
    assert sharding.split(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert sharding.split(2, 3) == [(0, 1), (1, 2), (2, 2)]
    x, y = torch.arange(14).reshape(7, 2), torch.arange(7.0)
    shards = sharding.shard_problems([CPU] * 3, 7, x, y)
    assert [(s.start, s.stop) for s in shards] == [(0, 3), (3, 5), (5, 7)]
    assert torch.equal(torch.cat([s.arrays[0] for s in shards]), x)
    assert len(sharding.shard_problems([CPU] * 3, 2, x[:2])) == 2
    assert sharding.gather_result([[1, 2], [3]]) == [1, 2, 3]


# ---------------------------------------------------------------------------
# kernel routes: sharded == unsharded == JAX sharded, draws pinned
# ---------------------------------------------------------------------------

# five problems at 20 positions whose het widths (9, 3, 2, 4, 1) compact
# the block to 16 positions, where a shard of problems 2-4 alone would
# compact to 8
HET_SETS = [(0, 2, 3, 5, 8, 11, 13, 17, 19), (1, 6, 9), (4, 15), (0, 7, 12, 18), (10,)]


def _k1_case():
    # ploidy 2 keeps the JAX interpreter's compile at 10 s of this file
    P, NB, A, S, chains = 2, 20, 2, 5, 2
    return (P, chains) + _wrapper_case(P, NB, A, S, chains, HET_SETS)


def test_k1_sharded_matches_unsharded_and_jax(monkeypatch):
    P, chains, log_reads, counts, init, nall, break_dist = _k1_case()
    steps, burn = 5, 1
    kw = dict(p_recomb=0.5, p_partial=0.5, p_full=1.0, burn=burn)
    widths = []
    launch = assemble.denovo_sampler

    def recording(lr, *args, **kwargs):
        widths.append((lr.shape[0], lr.shape[1], kwargs["chain_offset"]))
        return launch(lr, *args, **kwargs)

    monkeypatch.setattr(assemble, "denovo_sampler", recording)

    def port(devices):
        return assemble._fit_denovo_batch_kernel(
            log_reads, counts, init, nall, break_dist, P, steps, chains, seed=7,
            device=CPU, pinned_noise=PINNED, devices=devices, **kw,
        )

    whole = port(None)
    assert widths == [(5, 16, 0)]
    want = jax_assemble._fit_denovo_batch_pallas(
        log_reads, counts, init, nall, break_dist, P, steps, chains, seed=7,
        interpret=True, mesh=_jax_mesh(), **kw,
    )
    for key, devices in SHARDS.items():
        widths.clear()
        got = port(devices)
        # every shard at the block's compacted width, keyed from its first chain
        starts = [0, 3] if key == "2" else [0, 2, 4]
        sizes = np.diff(starts + [5]).tolist()
        assert widths == [(n, 16, s * chains) for n, s in zip(sizes, starts)]
        for g, w, j in zip(got, whole, want):
            np.testing.assert_array_equal(g.genotypes, w.genotypes)
            np.testing.assert_allclose(g.llks, w.llks, rtol=1e-6)
            np.testing.assert_array_equal(g.genotypes, j.genotypes)
            np.testing.assert_allclose(g.llks, j.llks, rtol=0, atol=1e-4)


def test_k1_sharded_tabulated_matches_unsharded():
    P, chains, log_reads, counts, init, nall, break_dist = _k1_case()

    def port(devices):
        return assemble._fit_denovo_batch_kernel(
            log_reads, counts, init, nall, break_dist, P, 6, chains, seed=7,
            p_recomb=0.5, p_partial=0.5, p_full=1.0, burn=2, tabulate=True,
            device=CPU, pinned_noise=0.3, devices=devices,
        )

    whole = port(None)
    for got in (port(SHARDS["2"]), port(SHARDS["3"])):
        for g, w in zip(got, whole):
            assert type(g) is type(w) is assemble.TabulatedGenotypeTrace
            # each shard pads its state table to its own widest chain:
            # the distinct states (count > 0) must agree, in order
            for c in range(chains):
                gm, wm = g.counts[c] > 0, w.counts[c] > 0
                for x, y in ((g.states, w.states), (g.counts, w.counts),
                             (g.first, w.first), (g.llks, w.llks)):
                    np.testing.assert_array_equal(x[c][gm], y[c][wm])
            np.testing.assert_array_equal(g.posterior().probabilities,
                                          w.posterior().probabilities)


def _k2_case(S=5, R=16, H=6, seed=2):
    rng = np.random.default_rng(seed)
    n_valid = np.array([6, 3, 5, 2, 6, 4, 5][:S], np.int32)
    rh = rng.uniform(-80.0, 0.0, size=(S, R, H))
    for s in range(S):
        rh[s, :, n_valid[s]:] = MIN_LOG
    counts = rng.integers(0, 3, size=(S, R)).astype(float)
    return rh, counts, n_valid


def test_k2_sharded_matches_unsharded_and_jax():
    rh, counts, n_valid = _k2_case()
    ploidy, steps, chains, burn = 4, 7, 3, 2
    want = jax_calling._fit_batch_pallas(
        jnp.asarray(rh), jnp.asarray(counts), ploidy, steps, chains, 4, rh.shape[-1],
        n_valid=n_valid, burn=burn, interpret=True, mesh=_jax_mesh(),
    )

    def port(devices):
        return calling._fit_batch_kernel(
            rh, counts, ploidy, steps, chains, 4, n_valid, burn, device=CPU,
            pinned_noise=PINNED, devices=devices,
        )

    whole = port(None)
    for devices in SHARDS.values():
        for g, w, j in zip(port(devices), whole, want):
            np.testing.assert_array_equal(g.genotypes, w.genotypes)
            np.testing.assert_allclose(g.llks, w.llks, rtol=1e-6)
            assert g.n_allele == w.n_allele
            np.testing.assert_array_equal(g.genotypes, j.genotypes)
            np.testing.assert_allclose(g.llks, j.llks, rtol=1e-4)


HAPS = np.array([[0, 0, 0], [0, 1, 1], [1, 1, 0], [1, 0, 1]], np.int8)


def _pedigree_problems(n_loci=5, n_progeny=4, ploidy=4, seed=0):
    """A 2 + n_progeny family at ``n_loci`` loci of 3 SNVs."""
    rng = np.random.default_rng(seed)
    S = 2 + n_progeny
    parents = np.array([[-1, -1]] * 2 + [[0, 1]] * n_progeny)
    problems = []
    for locus in range(n_loci):
        haps = HAPS[: 3 + locus % 2]
        genotypes = rng.integers(0, len(haps), size=(S, ploidy))
        reads = [simulate_reads(haps[g], n_alleles=2, n_reads=6, errors=False,
                                seed=10 * locus + s) for s, g in enumerate(genotypes)]
        problems.append(dict(sample_reads=np.stack(reads),
                             sample_read_counts=np.ones((S, 6), int), haplotypes=haps))
    design = (np.full(S, ploidy), parents, np.full((S, 2), ploidy // 2), np.zeros((S, 2)),
              np.full((S, 2), 0.01))
    return problems, design


def test_k3_sharded_matches_unsharded_and_jax():
    # diploid keeps the JAX interpreter's compile short
    problems, design = _pedigree_problems(n_loci=3, n_progeny=2, ploidy=2)
    steps, chains, burn = 3, 2, 1
    h_max = max(len(p["haplotypes"]) for p in problems)
    rh, counts, freqs, n_valid = pedigree._assemble_problems_np(problems, h_max)
    initial = np.asarray(pedigree._greedy_initial(
        torch.as_tensor(rh), torch.as_tensor(counts), torch.as_tensor(n_valid),
        design[0], 2,
    ))
    want = jax_pedigree._fit_pallas_multi(
        rh, counts, freqs, n_valid, initial, make_plan(*design), steps, chains, 3,
        burn, interpret=True, mesh=_jax_mesh(),
    )
    want = pedigree._sort_roll_trace(np.asarray(want), design[0], 2)

    def port(devices):
        trace, _ = pedigree._fit(
            problems, *design, steps, chains, 3, "Gibbs", True, burn, CPU,
            initial=initial, pinned_noise=PINNED, devices=devices,
        )
        return trace

    whole = port(None)
    np.testing.assert_array_equal(whole, want)
    for devices in SHARDS.values():
        np.testing.assert_array_equal(port(devices), whole)


# ---------------------------------------------------------------------------
# torch routes: placement-free, within the exact bounds
# ---------------------------------------------------------------------------


def _assert_placement_free(fit):
    """``fit(devices)``'s traces over 2 and 3 devices equal the unsharded
    run's bit for bit."""
    whole = fit(None)
    for devices in SHARDS.values():
        got = fit(devices)
        assert len(got) == len(whole)
        for a, b in zip(got, whole):
            np.testing.assert_array_equal(a.genotypes, b.genotypes)
            np.testing.assert_array_equal(a.llks, b.llks)


def test_torch_denovo_route_sharded():
    """test_torch_assemble_mcmc's mixed-inbreeding block (K1 refuses F =
    0): five problems unsharded and over two and three devices, and two
    over two devices, one problem each, against exact enumeration."""
    from test_torch_assemble_mcmc import TRUTH_P4, _exact_posterior, _reads, _sampled_posterior

    reads = _reads(TRUTH_P4, 8, (15, 25), 3)

    def fit(steps, chains, burn, devices=SHARDS["2"], fs=(0.0, 0.2)):
        problems = [dict(reads=reads, counts=np.ones(len(reads)), n_alleles=[2, 2],
                         inbreeding=f) for f in fs]
        fallback.PATHS.clear()
        traces = assemble.fit_denovo_multi(problems, 4, steps=steps, chains=chains,
                                           burn=burn, random_seed=5, device="cpu",
                                           devices=devices)
        assert dict(fallback.PATHS) == {("denovo", "torch"): 1}
        return traces

    _assert_placement_free(lambda devices: fit(20, 4, 5, devices, (0.0, 0.2, 0.0, 0.1, 0.2)))
    for f, trace in zip((0.0, 0.2), fit(160, 16, 40)):
        np.testing.assert_allclose(
            _sampled_posterior(trace.genotypes, 4), _exact_posterior(reads, 4, f), atol=0.05
        )


def test_torch_calling_route_sharded():
    """test_torch_calling_model's prior case (the torch sampler): five
    problems unsharded and over two and three devices, and two over two
    devices against exact enumeration."""
    reads = simulate_reads(HAPS[[0, 1, 1, 3]], n_alleles=2, n_reads=8, qual=(20, 30), seed=9)
    freqs = np.array([0.4, 0.3, 0.2, 0.1])
    problems = [
        dict(reads=reads, counts=np.ones(len(reads)), haplotypes=HAPS, inbreeding=0.1,
             frequencies=freqs),
        dict(reads=reads, counts=np.ones(len(reads)), haplotypes=HAPS[:3], inbreeding=0.3,
             frequencies=freqs[:3] / freqs[:3].sum()),
    ]

    def fit(steps, chains, burn, devices=SHARDS["2"], block=problems):
        fallback.PATHS.clear()
        traces = calling.fit_calling_multi(block, ploidy=4, steps=steps, chains=chains,
                                           random_seed=1, burn=burn, device="cpu",
                                           devices=devices)
        assert dict(fallback.PATHS) == {("calling", "torch"): 1}
        return traces

    _assert_placement_free(lambda devices: fit(30, 4, 5, devices, (problems * 3)[:5]))
    traces = fit(500, 48, 100)
    for t, k, f, panel in ((traces[0], 0.1, freqs, HAPS),
                           (traces[1], 0.3, freqs[:3] / freqs[:3].sum(), HAPS[:3])):
        llks = jax_exact.genotype_likelihoods(reads, 4, panel)
        want = np.asarray(jax_exact.genotype_posteriors(llks, 4, len(panel), prior=(k, f)))
        np.testing.assert_allclose(t.posterior().as_array(len(panel)), want, atol=0.06)


def test_torch_pedigree_route_sharded():
    """Metropolis-Hastings steps (the torch joint sampler) on five loci:
    unsharded and over two and three devices bit for bit, every allele
    inside its panel."""
    problems, design = _pedigree_problems(n_loci=5)

    def fit(devices):
        fallback.PATHS.clear()
        trace, _ = pedigree._fit(problems, *design, 6, 2, 3, "Metropolis-Hastings", True,
                                 0, CPU, devices=devices)
        assert dict(fallback.PATHS) == {("pedigree", "torch"): 1}
        return trace

    first = fit(None)
    for devices in SHARDS.values():
        np.testing.assert_array_equal(fit(devices), first)
    assert first.shape == (5, 2, 6, 6, 4)
    for locus, p in enumerate(problems):
        assert 0 <= first[locus].min() and first[locus].max() < len(p["haplotypes"])


# ---------------------------------------------------------------------------
# call-exact, pools, the sharded calling step
# ---------------------------------------------------------------------------


def test_exact_stats_sharded_equal():
    rng = np.random.default_rng(4)
    problems = []
    for i in range(7):
        panel = HAPS[: 2 + i % 3]
        reads = simulate_reads(panel[rng.integers(0, len(panel), 4)], n_alleles=2,
                               n_reads=5 + i, qual=(20, 30), seed=i)
        problems.append(dict(reads=reads, counts=np.ones(len(reads)), haplotypes=panel,
                             inbreeding=0.1 if i % 2 else None))
    whole = exact.exact_posterior_stats_multi(problems, 4, device="cpu")
    for devices in [None, *SHARDS.values()]:
        got = exact_stats_sharded(problems, 4, CPU, devices=devices)
        for g, w in zip(got, whole):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


def test_call_exact_block_path_sharded_vcf_bytes(tmp_path, monkeypatch):
    """``call-exact``'s block path with its problems over three devices
    writes the unsharded VCF byte for byte."""
    from mchap_tpu_torch.application.cli import main
    from test_torch_fixtures import write_dataset, write_haplotype_vcf

    data = write_dataset(tmp_path / "reads", n_samples=4, n_loci=3, seed=8)
    panel = write_haplotype_vcf(tmp_path / "panel.vcf", data)
    argv = ["mchap", "call-exact", "--bam", *data["bams"], "--haplotypes", panel,
            "--ploidy", "4", "--device", "cpu", "--locus-batch", "3"]

    def run():
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        return [line for line in out.getvalue().splitlines()
                if not line.startswith(("##fileDate", "##commandline"))]

    whole = run()
    blocks = []

    def three_devices(n, devices, device):
        blocks.append(n)
        return SHARDS["3"]

    monkeypatch.setattr(sharding, "problem_devices", three_devices)
    assert run() == whole
    assert blocks == [12]  # one block: 3 loci x 4 samples, split 4 + 4 + 4
    assert sum(not line.startswith("#") for line in whole) == 3


def test_pools_match_host_formulas_and_jax():
    """After tests/test_parallel.py:266-299: 13 problems (no multiple of
    2 or 3) pooled into 3 loci."""
    rng = np.random.default_rng(0)
    n_problems, n_loci, k = 13, 3, 5
    locus_ids = rng.integers(0, n_loci, n_problems).astype(np.int32)
    acp = rng.uniform(0, 4, (n_problems, k))
    aop = rng.uniform(0, 1, (n_problems, k))
    snvdp = rng.integers(0, 50, (n_problems, k)).astype(float)
    jmesh = Mesh(np.array(jax.devices()[:2]), ("loci",))
    placed = shard_pool_problems(jmesh, n_problems, n_loci, locus_ids, acp, aop, snvdp)
    want = [np.asarray(x) for x in pooled_info_collectives(jmesh, n_loci)(*placed)]
    host = [np.stack([f(sel) for sel in (locus_ids[:, None] == np.arange(n_loci)).T])
            for f in (lambda s: acp[s].sum(0), lambda s: aop[s].sum(0),
                      lambda s: 1 - np.prod(1 - aop[s], axis=0), lambda s: snvdp[s].sum(0))]
    for devices in (None, SHARDS["2"], SHARDS["3"]):
        got = [x.numpy() for x in pools.pooled_info(devices, n_loci, locus_ids, acp, aop, snvdp)]
        for g, w, h in zip(got, want, host):
            np.testing.assert_allclose(g, h, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_sharded_calling_step_pools_counts():
    """make_problem_batch gives JAX's read-hap matrix from the same rng
    draws; the sharded step's pooled counts are its traces' allele counts,
    and every placement gives the single device's genotypes."""
    args = (5, 2, 4, 8, 3, 4)
    batch = mesh.make_problem_batch(np.random.default_rng(1), *args)
    jbatch = jax_mesh.make_problem_batch(np.random.default_rng(1), *args)
    np.testing.assert_allclose(batch[1].numpy(), np.asarray(jbatch[1]), rtol=1e-6)
    step = mesh.sharded_calling_step(SHARDS["3"], n_steps=6, ploidy=4)
    g, llks, counts = step(3, *batch)
    assert g.shape == (5, 2, 6, 4) and llks.shape == (5, 2, 6)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(g.ravel(), minlength=4))
    for devices in ([CPU], SHARDS["2"]):
        g2, llks2, _ = mesh.sharded_calling_step(devices, n_steps=6, ploidy=4)(3, *batch)
        np.testing.assert_array_equal(g, g2)
        np.testing.assert_array_equal(llks, llks2)
