"""The precision control of each cell: the reference in bfloat16 in the
program's place has to come out as not correct under the cell's limits,
on the CPU at a small size and, on the card, at the cell's own size."""

import json

import pytest

from gpubench import control, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = dict(n_samples=6, n_loci=4, snvs_per_locus=[9, 8, 10, 9], reads_per_sample=32,
             n_triallelic=1, locus_length=120)


def _failed(cell, numbers):
    return [k for k, limit in cell["limits"].items() if numbers[k] > limit]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name):
    cell = run.load_cell(name)
    cell["dataset"] = dict(cell["dataset"], **SMALL)
    numbers, _ = control.control_numbers(cell)
    assert "llk_err_max" in _failed(cell, numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(card, name, capsys):
    cell = run.load_cell(name)
    numbers, _ = control.control_numbers(cell, device="cuda")
    with capsys.disabled():
        print(f"\ncontrol {name}: {json.dumps(numbers)}")
    assert _failed(cell, numbers), numbers
