"""A run without a card fails; nothing the harness loads is JAX or the
JAX package; the last line's keys; and, on the CPU at a small size with
the search for a card skipped, the faults a cell can have make
``correct`` come out false."""

import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import run

torch.set_num_threads(1)
SMALL = dict(n_samples=4, n_loci=3, snvs_per_locus=[9, 8, 10], reads_per_sample=24,
             n_triallelic=1, locus_length=120)
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
        "[run.load_tool(json.load(open(c['file']))['tool']) for c in bench['configs']]\n"
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


# every cell that has a file, each with the faults its tool file plants
CELLS = sorted(p.stem for p in (run.HERE / "workloads").glob("*.json"))


@contextlib.contextmanager
def fault(name, cell):
    import importlib

    from mchap_tpu_torch.io import vcf

    tool = run.load_tool(cell["tool"])
    mp = pytest.MonkeyPatch()
    try:
        if name == "state_unchanged":
            for module_name, fn, frozen in tool.unchanged_samplers():
                module = importlib.import_module(f"mchap_tpu_torch.{module_name}")
                mp.setattr(module, fn, frozen(getattr(module, fn)))
        elif name == "half_batch":
            module_name, fn = tool.SITE
            module = importlib.import_module(module_name)
            mp.setattr(module, fn, _half(getattr(module, fn)))
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
    steps, burn = run.load_tool(cell["tool"]).SMALL_RUN
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
