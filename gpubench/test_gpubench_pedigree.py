"""The tool ``call-pedigree`` and its cell: the fault and control tests
take the cell up; the pedigree reference imports only torch, the
standard library and the reference's own modules; K3's work count and
kernel name; the tap puts every
sampler back and keeps K3's launch count; the span readers read the
program's pedigree spans, and nothing where the program has none; the
control fails at a small size, naming its numbers, on the CPU and, on
the card, at the cell's size (the shared tests run it too)."""

import ast
import importlib
import json
import re

import pytest
import torch

from gpubench import control, run
from gpubench import test_gpubench_control as control_tests
from gpubench import test_gpubench_run as run_tests

torch.set_num_threads(1)
CELL = "call-pedigree.biparental"


def test_the_shared_fault_and_control_tests_take_the_cell():
    assert CELL in run_tests.CELLS and CELL in control_tests.CELLS
    tool = run.load_tool(run.load_cell(CELL)["tool"])
    assert [(m, n) for m, n, _ in tool.unchanged_samplers()] == [
        (m, n) for m, n, _ in tool.SAMPLERS]


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((run.HERE / "reference" / "pedigree.py").read_text())
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert names == {"math", "torch", "gpubench.reference"}


def test_k3_count():
    k3 = run.load_metric("k3_roofline")
    # two founders and one child: reads 3, 2 and 4; 5 haplotypes
    p = dict(reads=[3, 2, 4], haplotypes=5, parents=[[-1, -1], [-1, -1], [0, 1]])
    w = k3.problem_work(p, dict(ploidy=4, chains=2, steps=10))
    # per slot: R + H (3R + 1 + 13 trios); founders 1 trio (the child), the child 1
    slots = 4 * ((3 + 5 * (9 + 1 + 13)) + (2 + 5 * (6 + 1 + 13)) + (4 + 5 * (12 + 1 + 13)))
    swap = 4 * (3 + 2) + 13 * 3  # the pair's reads, the blanket's three trio terms
    trans = 4 * 5 * ((3 + 2) + (2 + 2) + (4 + 2)) + (3 + 2) + 3 + 1
    assert w == dict(flops=(slots + swap) * 20.0, transcendentals=trans * 20.0,
                     bytes=4 * 9 * 6 + 20 * 4 * 3.0)


def test_k3_kernel_name():
    k3 = run.load_metric("k3_roofline")
    assert re.search(k3.KERNELS, "void pedigree_kernel<4>(Params)")
    assert not re.search(k3.KERNELS, "calling_kernel(Params)")


def test_the_tap_puts_the_samplers_back_and_keeps_k3s_launch_count():
    from mchap_tpu_torch.application import call_pedigree
    from mchap_tpu_torch.ops import cuda_pedigree

    tool = run.load_tool("call-pedigree")
    before = {(m, n): getattr(importlib.import_module(f"mchap_tpu_torch.{m}"), n)
              for m, n, _ in tool.SAMPLERS}
    site = call_pedigree.fit_pedigree_multi
    with tool.tap(1):
        wrapped = cuda_pedigree.pedigree_sampler
        assert wrapped is not before[("ops.cuda_pedigree", "pedigree_sampler")]
        wrapped.launches = 0
        wrapped.launches += 1  # as K3's launch does, through the module's name
        assert cuda_pedigree.pedigree_sampler.launches == 1
    after = {(m, n): getattr(importlib.import_module(f"mchap_tpu_torch.{m}"), n)
             for m, n, _ in tool.SAMPLERS}
    assert after == before and call_pedigree.fit_pedigree_multi is site


def test_span_readers_read_the_pedigree_spans():
    spans = [("device_sampler", 0, 100), ("pedigree.prep", 10, 30),
             ("summarize_format", 100, 200), ("pedigree.incongruence", 110, 120),
             ("pedigree.posterior", 120, 180), ("pedigree.incongruence", 181, 185)]
    job = dict(ok=True, loci=2, spans=[(n, s * 10**6, e * 10**6) for n, s, e in spans])
    read = {n: run.load_metric(f"{n}.ms_per_locus").read(dict(jobs=[job]))
            for n in ("pedigree.prep", "pedigree.posterior", "pedigree.incongruence")}
    assert read == {"pedigree.prep": 10.0, "pedigree.posterior": 30.0,
                    "pedigree.incongruence": 7.0}
    # a program without them (the parent commit) reads nothing
    bare = dict(job, spans=[sp for sp in job["spans"] if not sp[0].startswith("pedigree.")])
    for n in read:
        assert run.load_metric(f"{n}.ms_per_locus").read(dict(jobs=[bare])) is None


def test_control_fails_small_by_its_numbers():
    cell = run.load_cell(CELL)
    cell["dataset"] = dict(cell["dataset"], **control_tests.SMALL)
    numbers, worst = control.control_numbers(cell)
    failed = [k for k, limit in cell["limits"].items() if numbers[k] > limit]
    print(json.dumps(numbers), json.dumps(worst))
    assert {"llk_err_max", "tab_diff"} <= set(failed), numbers
