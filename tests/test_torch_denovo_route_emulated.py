"""K4's CUDA source, run on the CPU, against its plain version.

``csrc/denovo_route_sampler.cu`` is compiled with g++ against
``cuda_emu.h`` (every GPU thread a fiber; warp collectives switch
fibers) and launched through the wrapper's own ``_launch`` on CPU
tensors.  The kernel makes its own draws and the plain version
(``ops/assemble_mcmc.denovo_sampler``) draws the same keyed stream
(``utils.philox.keyed_uniforms``), so the two must give identical
genotype traces and llks within 1e-9 (f64; only the order of the sums
over reads differs): flat, a Dirichlet-multinomial prior with one
problem at F = 0, 9 rungs, A = 3, a fixed interval count and ploidy 13.
Each case also launches the block's problems in two pieces, each with
its first row as ``row_offset``, and in pieces of rows cut by the
memory plan: both must equal the whole launch bit for bit.  Skips where
g++ is missing.
"""

import types

import numpy as np
import pytest
import torch

import emulated_cuda
from mchap_tpu_torch.ops import assemble_mcmc as M
from mchap_tpu_torch.ops import cuda_denovo_route as K4
from mchap_tpu_torch.ops import nvcc_build

torch.set_num_threads(1)

SOURCE = nvcc_build.CSRC / "denovo_route_sampler.cu"
SEED = (5 << 32) | 0x9E3779B9  # both halves of the seed in use


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def emulated(monkeypatch_module):
    """K4's library built for the host, loaded through the wrapper."""

    def build_library(name, source_name=None, defines=()):
        lib = emulated_cuda.build(SOURCE, defines)
        if lib is None:
            pytest.skip("g++ is needed to build the kernel source for the host")
        return lib

    monkeypatch_module.setattr(nvcc_build, "build_library", build_library)
    monkeypatch_module.setattr(K4, "_libs", {})
    monkeypatch_module.setattr(
        torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=None)
    )
    return K4.load_library()


def _block(P, NB, R, A, S=3, C=2, seed=0, inbreeding=None, n_intervals=None):
    """A block of S problems: reads from P haplotypes with 5% errors,
    counts 1-2, the last position of problem 0 fixed, random starts."""
    rng = np.random.default_rng(seed)
    reads = np.full((S, R, NB, A), 0.05 / (A - 1))
    for s in range(S):
        haps = rng.integers(0, A, (P, NB))
        calls = haps[rng.integers(0, P, R)]
        np.put_along_axis(reads[s], calls[:, :, None], 0.95, axis=2)
    n_alleles = np.full((S, NB), A)
    n_alleles[0, -1] = 1
    if n_intervals is None:
        break_dist = rng.dirichlet(np.ones(NB), S)
    else:
        break_dist = np.zeros((S, NB))
        break_dist[:, min(n_intervals, NB) - 1] = 1.0
    return dict(
        initial=torch.from_numpy(rng.integers(0, A, (S, C, P, NB))),
        log_reads=torch.from_numpy(np.log(reads)),
        read_counts=torch.from_numpy(rng.integers(1, 3, (S, R)).astype(float)),
        n_alleles=torch.from_numpy(n_alleles),
        break_dist=torch.from_numpy(break_dist),
        inbreeding=None if inbreeding is None else torch.tensor(inbreeding, dtype=torch.float64),
    )


def _run(fn, block, temps, steps, row_offset=0, lo=0, hi=None):
    """``fn`` on problems [lo, hi) of ``block`` alone."""
    cut = {k: None if v is None else v[lo:hi] for k, v in block.items()}
    return fn(SEED, row_offset, cut["initial"], cut["log_reads"], cut["read_counts"],
              cut["n_alleles"], cut["break_dist"], temps, n_steps=steps, burn=2,
              inbreeding=cut["inbreeding"], recombination_step_probability=0.5,
              partial_dosage_step_probability=0.5, dosage_step_probability=1.0)


def _plain(*args, **kw):
    return M.denovo_sampler(*args, cuda_graph=False, **kw)


LADDER9 = tuple(round(0.1 * i, 1) for i in range(2, 10)) + (1.0,)

CASES = {
    "flat": (dict(P=4, NB=6, R=8, A=2), (1.0,), 8),
    "prior, one problem at F = 0": (dict(P=3, NB=5, R=8, A=2, inbreeding=[0.0, 0.2, 0.1]),
                                    (0.5, 1.0), 8),
    "9 rungs": (dict(P=2, NB=4, R=6, A=2, C=1), LADDER9, 5),
    "A = 3": (dict(P=4, NB=5, R=8, A=3), (1.0,), 8),
    "n_intervals = 2": (dict(P=3, NB=6, R=8, A=2, n_intervals=2), (1.0,), 8),
    "ploidy 13": (dict(P=13, NB=3, R=6, A=2, C=1, S=2), (1.0,), 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_its_own_draws(emulated, case):
    """The kernel's trace is the plain version's: identical genotypes,
    llks within 1e-9, at a non-zero row offset; the chains move."""
    shape, temps, steps = CASES[case]
    block = _block(seed=len(case), **shape)
    g_k, l_k = _run(K4._launch, block, temps, steps, row_offset=1000)
    g_p, l_p = _run(_plain, block, temps, steps, row_offset=1000)
    assert g_k.shape == g_p.shape == (block["initial"].shape[:2] + (steps - 2,)
                                      + block["initial"].shape[2:])
    np.testing.assert_array_equal(g_k.numpy(), g_p.numpy())
    np.testing.assert_allclose(l_k.numpy(), l_p.numpy(), rtol=0, atol=1e-9)
    assert (g_k[:, :, 1:] != g_k[:, :, :-1]).any()


@pytest.mark.parametrize("case", list(CASES))
def test_row_offset_keys_draws_by_global_row(emulated, monkeypatch, case):
    """Problems launched in two pieces, each keyed from its first row in
    the whole block, and rows run in pieces of one chain each by the
    memory plan, equal the whole launch bit for bit; a piece keyed from
    row 0 replays other draws and differs."""
    shape, temps, steps = CASES[case]
    block = _block(seed=len(case), **shape)
    S, C = block["initial"].shape[:2]
    rows = C * len(temps)  # rows per problem
    g_all, l_all = _run(K4._launch, block, temps, steps)
    first = _run(K4._launch, block, temps, steps, 0, 0, 1)
    rest = _run(K4._launch, block, temps, steps, rows, 1, S)
    np.testing.assert_array_equal(torch.cat([first[0], rest[0]]).numpy(), g_all.numpy())
    np.testing.assert_array_equal(torch.cat([first[1], rest[1]]).numpy(), l_all.numpy())
    replay = _run(K4._launch, block, temps, steps, 0, 1, S)
    assert not torch.equal(replay[0], rest[0])

    planned = []
    real = K4.rows_per_piece

    def one_chain(n_rows, n_temps, per_row, device):
        planned.append(real(n_rows, n_temps, per_row, device))
        return n_temps

    monkeypatch.setattr(K4, "rows_per_piece", one_chain)
    launches = K4.denovo_route_sampler.launches
    g_cut, l_cut = _run(K4._launch, block, temps, steps)
    assert planned == [S * rows]  # the whole block fits the budget
    chains = S * C
    per_chain = 1 + steps * (1 + (len(temps) > 1))
    assert K4.denovo_route_sampler.launches - launches == chains * per_chain
    np.testing.assert_array_equal(g_cut.numpy(), g_all.numpy())
    np.testing.assert_array_equal(l_cut.numpy(), l_all.numpy())


def test_row_words_match_the_plain_draw_layout(emulated):
    """The kernel's draws per step are ``step_draw_offsets``' D."""
    for P, NB in ((2, 1), (4, 6), (13, 3), (16, 5)):
        assert K4.row_words(emulated, P, NB)[2] == M.step_draw_offsets(P, NB)["D"]


def test_wrapper_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; it refuses shapes the kernel cannot take."""
    block = _block(P=2, NB=3, R=4, A=2)
    monkeypatch.setattr(K4, "_launch", None)  # a launch would fail
    before = K4.denovo_route_sampler.launches
    got = _run(K4.denovo_route_sampler, block, (1.0,), 4)
    want = _run(_plain, block, (1.0,), 4)
    assert K4.denovo_route_sampler.launches == before
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    wide = _block(P=2, NB=3, R=4, A=9)
    with pytest.raises(ValueError, match="alleles"):
        _run(K4.denovo_route_sampler, wide, (1.0,), 4)
    with pytest.raises(ValueError, match="temperatures"):
        _run(K4.denovo_route_sampler, block, (1.0, 0.5), 4)
    with pytest.raises(ValueError, match="initial alleles"):
        _run(K4.denovo_route_sampler, dict(block, initial=block["initial"] + 2), (1.0,), 4)


def test_prior_tables_give_the_plain_prior():
    """(tab, const) of ``prior_tables`` rebuild ``log_genotype_prior_dosage``
    for flat and Dirichlet-multinomial rows."""
    from mchap_tpu_torch.ops.priors import log_genotype_prior_dosage

    P = 6
    f = torch.tensor([0.0, 0.1, 0.5])
    log_uh = torch.tensor([1.3, 2.0, 0.7], dtype=torch.float64)
    tab, const = K4.prior_tables(f, log_uh, P)
    for dosage in ([6, 0, 0, 0, 0, 0], [2, 0, 3, 0, 1, 0], [1] * 6):
        d = torch.tensor(dosage)
        want = log_genotype_prior_dosage(d.expand(3, P), log_uh, inbreeding=f)
        s = tab[:, d].sum(-1)
        got = torch.where(f == 0, (const - s) - P * log_uh, const + s)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
