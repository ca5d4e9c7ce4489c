"""Every cell, configuration, tool and per-layer metric that
BENCHMARK.json names is a file of its own, found by name, and parses;
and nothing outside the tool files knows a tool by its name."""

import json
import pathlib
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
    # every cell holds the exact counts at 0 and limits the sampler stage's result,
    # whatever its tool; every number compared is one its tool's judge computes, and
    # the cell limits what its tool adds (what the precision control or a fault fails)
    assert all(cell["limits"].get(k) == 0 for k in judge.EXACT)
    assert "llk_err_max" in cell["limits"]
    tool = run.load_tool(cell["tool"])
    assert set(cell["limits"]) <= set(tool.NUMBERS)
    for names, limit in tool.REQUIRED:
        limited = [k for k in names if k in cell["limits"]]
        assert limited, names
        if limit is not None:
            assert all(cell["limits"][k] == limit for k in limited)
    for kind in ("end_to_end", "per_layer"):
        assert run.cell_metrics(BENCH, entry["name"], kind)


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_file(entry):
    module = run.load_metric(entry["name"])
    assert module.UNIT == entry["unit"] and callable(module.read)
    assert entry["moves"] == "loci_per_s"
    assert module.read(dict(cell=run.load_cell(entry["workloads"][0]), jobs=[], window_s=None,
                            busy_s=None, kernel_seconds=lambda p: 0.0, card="none")) is None


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_tool_file(entry):
    config = json.loads((run.ROOT / entry["file"]).read_text())
    tool = run.load_tool(config["tool"])
    for name in ("tap", "answers_from_vcf", "judge", "control", "problems", "merge",
                 "unchanged_samplers"):
        assert callable(getattr(tool, name)), name
    assert isinstance(tool.Reference, type)
    assert len(tool.SITE) == 2 and len(tool.SMALL_RUN) == 2
    assert all(set(names) <= set(tool.NUMBERS) for names, _ in tool.REQUIRED)
    # a tool adds to the floor of what every cell limits, and never takes from it
    assert all(((k,), 0) in tool.REQUIRED for k in judge.EXACT)
    assert (("llk_err_max",), None) in tool.REQUIRED
    assert callable(run.load_metric(tool.WORK).window_work)


def test_a_tool_file_lacking_part_of_the_interface_is_refused(tmp_path, monkeypatch):
    (tmp_path / "tools").mkdir()
    (tmp_path / "tools" / "half-a-tool.py").write_text("NUMBERS = ()\n")
    monkeypatch.setattr(run, "HERE", tmp_path)
    with pytest.raises(AttributeError, match="half-a-tool.py lacks SITE, tap, Reference"):
        run.load_tool("half-a-tool")


def test_no_file_outside_the_tools_knows_a_tool_by_name():
    tools = sorted(p.stem for p in (run.HERE / "tools").glob("*.py"))
    assert {"assemble", "call"} <= set(tools)
    names = "|".join(re.escape(t) for t in tools)
    compared = re.compile(rf"""[=!]=\s*["']({names})["']|["']({names})["']\s*[=!]=|\bSITES\b""")
    found = []
    for path in sorted(run.HERE.rglob("*.py")):
        if "tools" in path.relative_to(run.HERE).parts or path == pathlib.Path(__file__):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if compared.search(line):
                found.append(f"{path.relative_to(run.HERE)}:{i}: {line.strip()}")
    assert not found, found
