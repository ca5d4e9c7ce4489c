"""Every cell, configuration and per-layer metric that BENCHMARK.json
names is a file of its own, found by name, and parses."""

import json
import re

import pytest

from gpubench import run
from gpubench.reference import judge

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} == {"loci_per_s", "setup_s"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"} and len(entry["why"]) <= 200
    config = json.loads((run.ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert entry["file"] == f"gpubench/configs/{entry['name']}.json"
    assert config["assumed"] and entry["reduced"] == []


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file(entry):
    cell = run.load_cell(entry["name"])
    assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["chips"] == 1
    # every number compared is one the judge computes, and the exact ones hold at 0
    assert set(cell["limits"]) <= set(judge.NUMBERS)
    exact = {"records_bad", "stats_diff", "mec_diff", "encode_diff", "summary_diff"}
    assert all(cell["limits"][k] == 0 for k in exact)
    # the sampler stage's result, and what the precision control or a fault fails
    assert "llk_err_max" in cell["limits"]
    assert {"gap_max", "gpm_err_max"} & set(cell["limits"])
    for kind in ("end_to_end", "per_layer"):
        assert run.cell_metrics(BENCH, entry["name"], kind)


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_file(entry):
    module = run.load_metric(entry["name"])
    assert module.UNIT == entry["unit"] and callable(module.read)
    assert entry["moves"] == "loci_per_s"
    assert module.read(dict(cell=run.load_cell(entry["workloads"][0]), jobs=[], window_s=None,
                            busy_s=None, kernel_seconds=lambda p: 0.0, card="none")) is None
