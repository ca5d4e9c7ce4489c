"""Tools as plug-ins: each tool's judge gives the numbers it gave before
the judge was split by tool; a tool, configuration and cell added as new
files alone run through ``run.measure`` and are judged by their own tool
file; and a traced job keeps the program's counters."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench import data, run

torch.set_num_threads(1)
TINY = dict(n_samples=3, n_loci=3, snvs_per_locus=[9, 8, 10], reads_per_sample=24,
            n_triallelic=1, locus_length=120)

# the bfloat16 control judged by the judge, on TINY from seed 2**35 + 7, as
# `reference/judge.py` gave them before it was split into `tools/<tool>.py`:
# (numbers, worst cases, problems, their distinct reads, and their haplotypes
# or free SNVs and free alleles)
BEFORE = {
    "call.biparental": (
        {"records_bad": 0, "stats_diff": 0, "mec_diff": 0, "encode_diff": 0, "summary_diff": 0,
         "tab_diff": 0, "unresolved": 0, "llk_err_max": 0.00804820403576862, "gap_max": 0.0,
         "gpm_err_max": 0.06270022883296011},
        {"llk_err_max": ["locus1", "sample2", -12.8125, -12.916454259297499],
         "gpm_err_max": ["locus3", "sample3", 1.0, 0.9373]},
        (9, 31, 45)),
    "assemble.parents-tempered": (
        {"records_bad": 0, "stats_diff": 0, "mec_diff": 0, "encode_diff": 0, "summary_diff": 0,
         "tab_diff": 6, "unresolved": 0, "llk_err_max": 0.00804820403576862, "gap_max": 0.0,
         "gpm_err_max": 0.02884293987869213},
        {"llk_err_max": ["locus1", "sample2", -12.8125, -12.916454259297499],
         "tab_diff": ["locus3", "sample2", 0, 1.0, None],
         "gpm_err_max": ["locus2", "sample1", 0.883, 0.911843]},
        (6, 22, 54, 110)),
}


def _tiny_cell(name, directory):
    cell = run.load_cell(name)
    cell["dataset"] = dict(cell["dataset"], **TINY)
    d = data.write_pool_one(directory, cell["dataset"], 2**35 + 7, 0)
    names = d["samples"]
    cell["samples"] = names if cell["samples"] == "all" else [names[i] for i in cell["samples"]]
    return cell, d


@pytest.mark.parametrize("name", list(BEFORE))
def test_control_judged_as_before_the_split(name, tmp_path):
    cell, d = _tiny_cell(name, tmp_path)
    tool = run.load_tool(cell["tool"])
    ref = tool.Reference(d, cell)
    numbers, worst = tool.judge(ref, *tool.control(ref))
    want_numbers, want_worst, want_problems = BEFORE[name]
    assert numbers == want_numbers
    assert json.loads(json.dumps(worst)) == want_worst
    problems = tool.problems(ref, cell)
    shape = (len(problems), sum(p["reads"] for p in problems))
    if "haplotypes" in problems[0]:
        shape += (sum(p["haplotypes"] for p in problems),)
    else:
        shape += (sum(len(p["free_alleles"]) for p in problems),
                  sum(sum(p["free_alleles"]) for p in problems))
    assert shape == want_problems


def test_a_missing_site_fails_the_run_naming_it():
    from gpubench import taps

    site = ("mchap_tpu_torch.application.call", "fit_nothing_of_the_kind")
    with pytest.raises(LookupError, match="application.call.fit_nothing_of_the_kind"):
        with taps.tap(site, 1):
            pass


# a tool, a configuration and a cell added as new files only
ALIAS_TOOL = '''"""The tool ``call`` under another name."""
from gpubench import run

globals().update({k: v for k, v in vars(run.load_tool("call")).items()
                  if not k.startswith("__")})
'''

MEASURE_BOTH = '''
import json, sys
import torch
torch.set_num_threads(1)
from gpubench import run

asked = []
load_tool = run.load_tool
run.load_tool = lambda name: asked.append(name) or load_tool(name)
out = {}
for tool in ("call-alias", "call"):
    cell = dict(run.load_cell("call.alias"), tool=tool)
    lines = []
    result, checks = run.measure(cell, 2**36 + 9, 0.0, False, run.boot_seconds(),
                                 device="cpu", log=lines.append)
    out[tool] = dict(correct=result["correct"], checks=checks,
                     numbers=[l.split(" numbers ", 1)[1] for l in lines if " numbers " in l])
print(json.dumps(dict(out, asked=asked)))
'''


def test_a_tool_added_as_new_files_runs_and_is_judged_by_its_own_file(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(run.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    (root / "mchap_tpu_torch").symlink_to(run.ROOT / "mchap_tpu_torch")
    here = root / "gpubench"
    (here / "tools" / "call-alias.py").write_text(ALIAS_TOOL)
    config = json.loads((here / "configs" / "biparental-call.json").read_text())
    config.update(name="biparental-call-alias", tool="call-alias")
    (here / "configs" / "biparental-call-alias.json").write_text(json.dumps(config))
    cell = json.loads((here / "workloads" / "call.biparental.json").read_text())
    cell.update(config="biparental-call-alias", traffic="alias", pool=1, dataset=TINY,
                options=["--mcmc-steps", "200", "--mcmc-burn", "100"])
    (here / "workloads" / "call.alias.json").write_text(json.dumps(cell))
    env = dict(os.environ, MCHAP_LOCUS_BATCH="32", TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", MEASURE_BOTH], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    # the alias's cell asked for its own tool file, which loads `call`'s; then `call`
    assert out["asked"] == ["call-alias", "call", "call"]
    alias, call = out["call-alias"], out["call"]
    assert alias["correct"] and alias["numbers"] and alias == call


def test_a_traced_job_keeps_the_programs_counters(tmp_path, monkeypatch):
    from gpubench import jobs

    monkeypatch.setenv("MCHAP_LOCUS_BATCH", "32")
    cell = run.load_cell("call.biparental")
    cell["dataset"] = dict(cell["dataset"], **TINY)
    d = data.write_pool_one(tmp_path, cell["dataset"], 2**35 + 8, 0)
    cell["samples"] = d["samples"]
    argv = run.job_argv(cell, d, 5, "cpu") + ["--mcmc-steps", "200", "--mcmc-burn", "100"]
    traced = jobs.run_job(argv, True)
    assert traced["ok"], traced["error"]
    # 3 samples x 3 loci, every locus with SNVs
    assert traced["counters"]["sampler.problems"] == 9
    untraced = jobs.run_job(argv, False)
    assert untraced["ok"] and untraced["counters"] == {}
    metric = run.load_metric("denovo.overflow_pct")
    assert metric.read(dict(jobs=[dict(traced, loci=3)])) == 0.0
    assert metric.read(dict(jobs=[dict(untraced, loci=3)])) is None
