"""Multi-process runs of the port: ``parallel/distributed.py`` and the
launcher, after ``tests/test_distributed.py``.

- ``MCHAP_DISTRIBUTED`` parsing and idempotence with
  ``init_process_group`` mocked; bad specs raise; the rank's device and
  output duty.
- Two real processes joined through gloo on the CPU, started by the
  package's launcher: ``fit_calling_multi``'s K2 route with every draw
  pinned gives both ranks the single-process genotypes, and only rank 0
  is the output process.
- ``python -m mchap_tpu_torch call`` in two ranks: rank 0 writes the
  records a single process writes with the block split the same way
  (the plain K2 seeds each shard's generator from its first chain), and
  rank 1 writes nothing.
"""

import contextlib
import io
import os
import time

import numpy as np
import pytest
import torch

from mchap_tpu_torch.parallel import distributed, launch, sharding
from test_torch_fixtures import write_dataset, write_haplotype_vcf

torch.set_num_threads(1)


@pytest.fixture
def fake_group(monkeypatch):
    """``torch.distributed`` with init_process_group recorded, not run."""
    calls, state = [], {"init": False}

    def init_process_group(backend, **kwargs):
        calls.append(dict(backend=backend, **kwargs))
        state["init"] = True

    monkeypatch.setattr(distributed.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: state["init"])
    monkeypatch.setattr(distributed.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 4)
    return calls


@pytest.mark.parametrize("spec, want", [
    ("node0:8476,4,2", dict(backend="gloo", init_method="tcp://node0:8476",
                            world_size=4, rank=2, timeout=distributed.TIMEOUT)),
    (" auto ", dict(backend="gloo", init_method="env://", timeout=distributed.TIMEOUT)),
    ("1", dict(backend="gloo", init_method="env://", timeout=distributed.TIMEOUT)),
])
def test_maybe_initialize_parses_spec(fake_group, monkeypatch, spec, want):
    monkeypatch.setenv("MCHAP_DISTRIBUTED", spec)
    assert distributed.maybe_initialize()
    assert distributed.maybe_initialize()  # idempotent
    assert fake_group == [want]
    assert distributed.world() == (1, 4)


@pytest.mark.parametrize("spec", ["", "0"])
def test_maybe_initialize_off(fake_group, monkeypatch, spec):
    monkeypatch.setenv("MCHAP_DISTRIBUTED", spec)
    assert not distributed.maybe_initialize()
    assert fake_group == [] and distributed.world() == (0, 1)
    assert distributed.is_output_process()


@pytest.mark.parametrize("spec", ["node0:8476,4", "node0:8476,four,1", "node0"])
def test_maybe_initialize_rejects_bad_specs(fake_group, monkeypatch, spec):
    monkeypatch.setenv("MCHAP_DISTRIBUTED", spec)
    with pytest.raises(ValueError, match="MCHAP_DISTRIBUTED"):
        distributed.maybe_initialize()
    assert fake_group == []


def test_rank_device_and_output_duty(fake_group, monkeypatch):
    monkeypatch.setenv("MCHAP_DISTRIBUTED", "node0:8476,4,1")
    distributed.maybe_initialize()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.rank_device(torch.device("cuda", 0)) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.rank_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert distributed.rank_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.delenv("MCHAP_EMIT_ALL_HOSTS", raising=False)
    assert not distributed.is_output_process()  # rank 1
    monkeypatch.setenv("MCHAP_EMIT_ALL_HOSTS", "1")
    assert distributed.is_output_process()


_FAILING_RANK = """
import os, sys, time
rank = int(os.environ["MCHAP_DISTRIBUTED"].rsplit(",", 1)[1])
if {wait!r} == "collective":
    from mchap_tpu_torch.parallel import distributed
    distributed.maybe_initialize()
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    distributed.all_gather(rank)
elif rank == 1:
    sys.exit(3)
time.sleep(600)
"""


@pytest.mark.parametrize("wait", ["collective", "hang"])
def test_failing_rank_ends_the_launch(wait):
    """Rank 1 fails while rank 0 waits for it in a collective (or hangs):
    the launcher kills rank 0 and returns at once, not at the group's
    timeout."""
    start = time.monotonic()
    codes = launch.launch(["-c", _FAILING_RANK.format(wait=wait)], 2, timeout=120)
    assert time.monotonic() - start < 60
    assert codes[0] != 0 and codes[1] == (1 if wait == "collective" else 3)


def test_two_gloo_processes_fit_the_single_process_genotypes():
    """Both ranks gather the genotypes one process computes, and rank 0
    alone is the output process (checked inside ``launch.smoke``)."""
    got = launch.smoke(nproc=2, timeout=120)
    want = launch.smoke_fit(launch.smoke_problems(), devices=None)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 2, 20, 4)


def test_two_rank_call_writes_from_rank_zero_only(tmp_path, monkeypatch):
    from mchap_tpu_torch.application.cli import main

    data = write_dataset(tmp_path / "reads", seed=0)
    panel = write_haplotype_vcf(tmp_path / "haplotypes.vcf", data)
    tool = ["call", "--bam", *data["bams"], "--ploidy", "4", "--haplotypes", panel,
            "--reference", data["reference"], "--mcmc-steps", "60", "--mcmc-burn", "20",
            "--mcmc-seed", "3", "--device", "cpu", "--locus-batch", "3"]
    outs = [tmp_path / f"rank{r}.vcf" for r in range(2)]
    env = {k: v for k, v in os.environ.items() if k != "MCHAP_EMIT_ALL_HOSTS"}
    codes = launch.launch(["-m", "mchap_tpu_torch", *tool], 2, stdout=outs, timeout=120,
                          env=env)
    assert codes == [0, 0]
    assert outs[1].read_text() == ""

    # one process with the block split over two devices as the two ranks split it
    blocks = []

    def two_devices(n, devices, device):
        blocks.append(n)
        return [torch.device("cpu")] * 2

    monkeypatch.setattr(sharding, "problem_devices", two_devices)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["mchap", *tool]) == 0
    assert blocks == [9]  # one block: 3 loci x 3 samples

    def records(text):
        return [line for line in text.splitlines()
                if not line.startswith(("##fileDate", "##commandline"))]

    got, want = records(outs[0].read_text()), records(out.getvalue())
    assert got == want
    assert sum(not line.startswith("#") for line in got) == 3
