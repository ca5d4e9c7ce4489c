"""A run without a card fails; nothing the harness loads is JAX or the
JAX package; the last line's keys; and, on the CPU at a small size with
the search for a card skipped, the faults a cell can have make
``correct`` come out false."""

import contextlib
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from gpubench import run

torch.set_num_threads(1)
SMALL = dict(n_samples=4, n_loci=3, snvs_per_locus=[9, 8, 10], reads_per_sample=24,
             n_triallelic=1, locus_length=120)
CELLS = ["assemble.biparental", "call.biparental", "assemble.parents-tempered",
         "call.biparental-dirmul"]
FAULTS = ["state_unchanged", "half_batch", "answer_altered", "calls_dotted"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", "call.biparental",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("mchap_tpu_torch.fake_module", "jaxtyping_fake", "mchap_tpu_fake"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mchap_tpu.fake_module", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "mchap_tpu"]


def test_harness_and_program_import_no_jax():
    code = (
        "import json, sys\n"
        "from gpubench import run, jobs, trace, data, control\n"
        "from gpubench.reference import judge, model, reads\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "[run.load_metric(m['name']) for m in bench['per_layer']]\n"
        "import mchap_tpu_torch.application.cli, mchap_tpu_torch.application.assemble\n"
        "import mchap_tpu_torch.application.call\n"
        "list(jobs._counters())\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


# -- faults, on the CPU --------------------------------------------------


def _k1_unchanged(real):
    """K1 (``ops/cuda_denovo.denovo_sampler``) whose every step returns the
    chains' initial state, with that state's log-likelihood."""
    from mchap_tpu_torch.ops import cuda_denovo

    def frozen(lr, counts, g_init, nall, pbreak, problem, *, n_steps, **kwargs):
        trace, _ = real(lr, counts, g_init, nall, pbreak, problem, n_steps=1, **kwargs)
        P = g_init.shape[0]
        base = cuda_denovo.next_pow2(max(lr.shape[2], 2))
        packed = sum(g_init[h].long() * base ** h for h in range(P))  # [NB, C]
        prob = problem.long()
        # lr [S, NB, A, R]: each haplotype's read log-probability, summed over sites
        per_site = torch.stack([
            torch.gather(lr[prob], 2, g_init[h].long().T[:, :, None, None]
                         .expand(-1, -1, 1, lr.shape[3]))[:, :, 0] for h in range(P)])
        hap = per_site.sum(dim=2)  # [P, C, R]
        llk = ((torch.logsumexp(hap, dim=0) - math.log(P)) * counts[prob]).sum(dim=1)
        return (packed.to(trace.dtype)[None].repeat(n_steps, 1, 1),
                llk.to(torch.float32)[None].repeat(n_steps, 1))
    return frozen


def _k2_unchanged(real):
    """K2 (``ops/cuda_calling.calling_sampler``, which starts every slot at
    the panel's first haplotype) whose every step returns that state."""
    def frozen(rh, counts, n_valid, problem, *, n_steps, ploidy, **kwargs):
        alleles, _ = real(rh, counts, n_valid, problem, n_steps=1, ploidy=ploidy, **kwargs)
        prob = problem.long()
        llk = (rh[prob][:, :, 0] * counts[prob]).sum(dim=1)  # every slot on haplotype 0
        return (torch.zeros_like(alleles).repeat(n_steps, 1, 1),
                llk.to(torch.float32)[None].repeat(n_steps, 1))
    return frozen


def _route_unchanged(real):
    """The torch calling route (``ops/calling_mcmc.calling_sampler``) whose
    every step returns its initial state."""
    def frozen(seed, row_offset, initial, read_hap, read_counts, *, n_steps, **kwargs):
        S, C, P = initial.shape
        rows = torch.arange(S, device=read_hap.device)[:, None, None]
        rh = read_hap[rows, :, initial.long()]  # [S, C, P, R]
        llk = ((torch.logsumexp(rh, dim=2) - math.log(P)) * read_counts[:, None, :]).sum(-1)
        return (initial[:, :, None, :].repeat(1, 1, n_steps, 1).long(),
                llk[:, :, None].repeat(1, 1, n_steps))
    return frozen


def _half(real):
    """The block fit with half of its problems left out: their traces are
    the other half's."""
    def half(problems, *args, **kwargs):
        n = len(problems)
        h = max(1, n // 2)
        out = real(problems[:h], *args, **kwargs)
        return [out[i % h] for i in range(n)]
    return half


def _altered(real):
    """The first sample's genotype of every record altered as it is written."""
    def altered(precision=3, **kwargs):
        gt = list(kwargs["GT"])
        first = list(gt[0])
        gt[0] = [1 if first[0] == 0 else 0] * len(first)
        kwargs["GT"] = gt
        return real(precision=precision, **kwargs)
    return altered


def _dotted(real):
    """Every genotype written with its alleles unknown ('.')."""
    def dotted(precision=3, **kwargs):
        kwargs["GT"] = [[-1] * len(g) for g in kwargs["GT"]]
        return real(precision=precision, **kwargs)
    return dotted


@contextlib.contextmanager
def fault(name, cell):
    from mchap_tpu_torch.application import assemble as app_assemble
    from mchap_tpu_torch.application import call as app_call
    from mchap_tpu_torch.io import vcf
    from mchap_tpu_torch.models import assemble as m_assemble
    from mchap_tpu_torch.models import calling as m_calling

    mp = pytest.MonkeyPatch()
    try:
        if name == "state_unchanged":
            if cell["tool"] == "assemble":
                mp.setattr(m_assemble, "denovo_sampler", _k1_unchanged(m_assemble.denovo_sampler))
            elif cell.get("inbreeding"):
                mp.setattr(m_calling._mcmc, "calling_sampler",
                           _route_unchanged(m_calling._mcmc.calling_sampler))
            else:
                mp.setattr(m_calling, "calling_sampler", _k2_unchanged(m_calling.calling_sampler))
        elif name == "half_batch":
            mp.setattr(app_assemble, "fit_denovo_multi", _half(app_assemble.fit_denovo_multi))
            mp.setattr(app_call, "fit_calling_multi", _half(app_call.fit_calling_multi))
        elif name == "answer_altered":
            mp.setattr(vcf, "format_sample_field", _altered(vcf.format_sample_field))
        elif name == "calls_dotted":
            mp.setattr(vcf, "format_sample_field", _dotted(vcf.format_sample_field))
        yield
    finally:
        mp.undo()


def small_cell(name):
    cell = run.load_cell(name)
    cell["dataset"] = dict(cell["dataset"], **SMALL)
    steps, burn = (1000, 500) if cell["tool"] == "call" else (400, 200)
    cell["options"] = cell["options"] + ["--mcmc-steps", str(steps), "--mcmc-burn", str(burn)]
    cell["pool"] = 2
    return run.apply_options(cell)


def _measure(cell, seed, monkeypatch):
    # the block path, as on the card (on the CPU the program's default is per locus)
    monkeypatch.setenv("MCHAP_LOCUS_BATCH", "32")
    return run.measure(cell, seed, 0.0, False, run.boot_seconds(), device="cpu",
                       log=lambda *a: None)


def test_last_line_keys(monkeypatch, capsys):
    result, checks = _measure(small_cell("call.biparental"), 2**40 + 1, monkeypatch)
    assert run.finish(result, checks, run.forbidden_modules()) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"loci_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_faults_make_correct_false(name, monkeypatch):
    cell = small_cell(name)
    seed = 2**40 + 17
    sound, checks = _measure(dict(cell), seed, monkeypatch)
    assert sound["failed"] == 0
    assert sound["correct"], checks
    for f in FAULTS:
        with fault(f, cell):
            result, fchecks = _measure(dict(cell), seed, monkeypatch)
        assert not result["correct"], (f, fchecks)


# -- on the card, at the cell's size ---------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 101, 2**33 + 202, 2**33 + 303])
@pytest.mark.parametrize("f", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_faults_at_cell_size(card, name, f, seed, capsys):
    """Each fault at the cell's own size: one window job, judged."""
    cell = run.load_cell(name)
    with fault(f, cell):
        result, checks = run.measure(cell, seed, 0.0, False, run.boot_seconds(),
                                        log=lambda *a: None)
    with capsys.disabled():
        print(f"\nfault {name} {f} {seed}: " + json.dumps({k: c["value"] for k, c in checks.items()}))
    assert not result["correct"]
