"""The port's spans and counters (``mchap_tpu_torch/utils/timing.py``).

Unit tests of the span record, then small runs of the tools on the CPU
with ``MCHAP_TIMING=1`` and ``MCHAP_TRACE``: every span where it belongs
in the one tree of the block loop (``application/baseclass.py``), at
any block size, the counters against the VCF, the trace file, and the
benchmark's span readers (``gpubench/metrics/``) on one job.  The
test marked ``cuda`` holds a kernel's ``torch.profiler`` interval to the
span it was launched in; on a machine with a card:
``python -m pytest --noconftest -m cuda -s tests/test_torch_tracing.py``.
"""

import contextlib
import io
import json
import pathlib
import re
import time

import pytest
import torch

from mchap_tpu_torch.application.cli import main
from mchap_tpu_torch.utils import fallback, timing
from test_torch_fixtures import parse_vcf_records, write_dataset, write_haplotype_vcf

torch.set_num_threads(1)

#: each span the tools open, with the name of its parent (None: a root)
PARENT = {
    "read_loci": None,
    "block": None,
    "encode_reads": "block",
    "io.read_extract": "encode_reads",
    "io.alignment_load": "io.read_extract",
    "encoding.reads": "encode_reads",
    "device_sampler": "block",
    "device.launch": "device_sampler",
    "device.sync": "device_sampler",
    "device.homfilter": "device_sampler",
    "host.chain_init": "device_sampler",
    "device.tabulate": "device_sampler",
    "device.trace_fetch": "device_sampler",
    "device.trace_unpack": "device_sampler",
    "summarize_format": "block",
    "posterior.samples": "summarize_format",
    "host.posterior_tab": "posterior.samples",
    "vcf.record": "summarize_format",
}
#: the spans every block of every tool opens
REQUIRED = {
    "read_loci", "block", "encode_reads", "io.read_extract", "io.alignment_load",
    "encoding.reads", "device_sampler", "device.launch", "device.sync",
    "summarize_format", "posterior.samples", "vcf.record",
}


@pytest.fixture(autouse=True)
def fresh_timers(monkeypatch):
    for name in ("MCHAP_TIMING", "MCHAP_TRACE", "MCHAP_PROGRESS"):
        monkeypatch.delenv(name, raising=False)
    timing.reset()
    yield
    monkeypatch.undo()
    timing.reset()


def _enabled(monkeypatch, tmp_path):
    """Recording on, with every span kept (``MCHAP_TRACE``)."""
    monkeypatch.setenv("MCHAP_TIMING", "1")
    monkeypatch.setenv("MCHAP_TRACE", str(tmp_path / "trace.json"))
    return timing.reset()


def _nested_spans():
    with timing.stage("outer", block=0):
        with timing.stage("inner", locus="L1"):
            time.sleep(0.002)
            timing.count("io.reads_extracted", 4)
        with timing.stage("inner", locus="L2"):
            time.sleep(0.002)
        time.sleep(0.002)


def test_nested_spans_ids_parents_and_self_time(monkeypatch, tmp_path):
    timers = _enabled(monkeypatch, tmp_path)
    _nested_spans()
    outer, inner1, inner2 = timers.spans
    assert [s.id for s in timers.spans] == [1, 2, 3]
    assert (outer.parent, inner1.parent, inner2.parent) == (None, 1, 1)
    assert outer.attrs == {"block": 0} and inner2.attrs == {"locus": "L2"}
    rows = {path: (n, total, own) for path, n, total, own in timers.span_tree()}
    n, total, own = rows[("outer",)]
    children = rows[("outer", "inner")]
    assert n == 1 and children[0] == 2
    assert own == pytest.approx(total - children[1], abs=1e-9)
    assert own >= 0.002 and children[2] == pytest.approx(children[1], abs=1e-9)


def test_stage_totals_count_nested_time_in_each_span(monkeypatch, tmp_path):
    timers = _enabled(monkeypatch, tmp_path)
    with timing.stage("outer"):
        with timing.stage("inner"):
            time.sleep(0.003)
    outer, inner = timers.spans
    assert timers.stages["outer"] == (outer.end - outer.start) / 1e9
    assert timers.stages["inner"] == (inner.end - inner.start) / 1e9
    assert timers.stages["outer"] >= timers.stages["inner"] >= 0.003


def test_off_records_no_span_and_no_counter():
    timers = timing.TIMERS
    assert not timers.enabled
    with timing.stage("outer", locus="L1"):
        with timing.stage("inner"):
            timing.count("io.reads_extracted", 5)
    assert timing.stage("x") is timing.stage("y", sample="s")  # one shared no-op
    assert timers.spans == [] and timers.stages == {}
    assert timers.counters == {} and timers.counter_events == []


def test_timing_alone_keeps_totals_not_spans(monkeypatch):
    """``MCHAP_TIMING`` without ``MCHAP_TRACE`` sums each span into its
    path's totals as it closes and keeps no span or counter event."""
    monkeypatch.setenv("MCHAP_TIMING", "1")
    timers = timing.reset()
    _nested_spans()
    assert timers.spans == [] and timers.counter_events == []
    assert timers.counters == {"io.reads_extracted": 4}
    rows = {path: (n, total, own) for path, n, total, own in timers.span_tree()}
    assert list(rows) == [("outer",), ("outer", "inner")]
    (n, total, own), (n_in, total_in, own_in) = rows.values()
    assert (n, n_in) == (1, 2) and own_in == total_in
    assert own == pytest.approx(total - total_in, abs=1e-9) and own >= 0.002
    assert timers.stages["outer"] == pytest.approx(total, abs=1e-9)
    assert "  inner" in "\n".join(timers.summary_lines())


def test_span_bounds_on_the_time_ns_clock(monkeypatch, tmp_path):
    timers = _enabled(monkeypatch, tmp_path)
    before = time.time_ns()
    with timing.stage("outer"):
        time.sleep(0.001)
    after = time.time_ns()
    (span,) = timers.spans
    assert before <= span.start < span.end <= after


def test_wrapper_in_place_of_stage_sees_every_span(monkeypatch, tmp_path):
    """A wrapper that replaces ``TIMERS.stage`` as ``gpubench/jobs.py``
    does (taking the name alone) sees nested spans too, and the program
    still records their attributes."""
    timers = _enabled(monkeypatch, tmp_path)
    seen = []
    program_stage = timers.stage

    @contextlib.contextmanager
    def stage(name):
        t0 = time.time_ns()
        try:
            with program_stage(name):
                yield
        finally:
            seen.append((name, t0, time.time_ns()))

    timers.stage = stage
    with timing.stage("encode_reads"):
        for sample in ("a", "b"):
            with timing.stage("io.read_extract", locus="L1", sample=sample):
                with timing.stage("io.alignment_load", file="x.sam"):
                    pass
    assert [name for name, _, _ in seen] == [
        "io.alignment_load", "io.read_extract", "io.alignment_load", "io.read_extract",
        "encode_reads",
    ]
    assert [s.attrs for s in timers.spans if s.name == "io.read_extract"] == [
        {"locus": "L1", "sample": "a"}, {"locus": "L1", "sample": "b"},
    ]
    outer = seen[-1]
    assert all(outer[1] <= s <= e <= outer[2] for _, s, e in seen)


def test_counters_and_summary(monkeypatch, tmp_path):
    timers = _enabled(monkeypatch, tmp_path)
    with timing.stage("encode_reads"):
        timing.count("io.reads_extracted", 40)
        timing.count("encoding.unique_reads", 10)
        timing.count("io.reads_extracted", 40)
    assert timers.counters == {"io.reads_extracted": 80, "encoding.unique_reads": 10}
    assert [(name, total) for _, name, total in timers.counter_events] == [
        ("io.reads_extracted", 40), ("encoding.unique_reads", 10), ("io.reads_extracted", 80),
    ]
    text = "\n".join(timers.summary_lines())
    assert "io.reads_extracted 80" in text
    assert "0.1250 unique reads per read extracted" in text


# -- the tools on the CPU ------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    directory = tmp_path_factory.mktemp("tracing")
    data = write_dataset(directory, n_samples=3, n_loci=3, seed=0)
    data["haplotypes"] = write_haplotype_vcf(directory / "haplotypes.vcf", data)
    return data


def _argv(data, tool, locus_batch=3):
    argv = ["mchap", tool, "--bam", *data["bams"], "--ploidy", "4",
            "--reference", data["reference"], "--device", "cpu",
            "--locus-batch", str(locus_batch)]
    if tool != "call-exact":
        argv += ["--mcmc-steps", "20", "--mcmc-burn", "5"]
    if tool in ("call", "call-exact"):
        return argv + ["--haplotypes", data["haplotypes"]]
    return argv + ["--targets", data["targets"], "--variants", data["variants"]]


@pytest.mark.parametrize("tool,locus_batch", [
    pytest.param(tool, batch, id=f"{tool}-{name}")
    for tool, runs in (("call", (3, 1)), ("assemble", (3, 1)), ("call-exact", (3,)))
    for batch, name in zip(runs, ("block", "block_of_one"))
])
def test_cli_spans_counters_and_trace(dataset, tool, locus_batch, monkeypatch, tmp_path):
    """A block of 3 loci, or 3 blocks of one: the same tree either way."""
    trace_path = tmp_path / "trace.json"
    monkeypatch.setenv("MCHAP_TIMING", "1")
    monkeypatch.setenv("MCHAP_TRACE", str(trace_path))
    timers = timing.reset()
    fallback.PATHS.clear()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(_argv(dataset, tool, locus_batch)) == 0
    records = parse_vcf_records(out.getvalue())
    assert len(records) == 3

    by_id = {s.id: s for s in timers.spans}
    names = {s.name for s in timers.spans}
    assert REQUIRED <= names <= set(PARENT)
    for s in timers.spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent == PARENT[s.name], (s.name, parent)
        assert s.end is not None
    blocks = [s.attrs for s in timers.spans if s.name == "block"]
    assert blocks == [{"block": i, "loci": locus_batch} for i in range(3 // locus_batch)]
    extracts = [s for s in timers.spans if s.name == "io.read_extract"]
    assert {(s.attrs["locus"], s.attrs["sample"]) for s in extracts} == {
        (r["ID"], sample) for r in records for sample in dataset["samples"]
    }
    for name in ("posterior.samples", "vcf.record"):
        assert [s.attrs for s in timers.spans if s.name == name] == [
            {"locus": r["ID"]} for r in records]

    counters = timers.counters
    rcount = sum(int(c["RCOUNT"]) for r in records for c in r["calls"].values())
    assert counters["io.reads_extracted"] == rcount > 0
    assert 0 < counters["encoding.unique_reads"] <= rcount
    assert counters["sampler.problems"] == 3 * len(dataset["samples"])
    assert counters["io.records_decoded"] > 0
    assert (counters.get("sampler.steps", 0) > 0) == (tool != "call-exact")
    summary = err.getvalue()
    assert "io.read_extract" in summary and "unique reads per read extracted" in summary

    trace = json.loads(trace_path.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    ids = {e["args"]["id"] for e in spans}
    assert len(spans) == len(timers.spans) == len(ids)
    assert all(e["args"]["parent"] is None or e["args"]["parent"] in ids for e in spans)
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"} == set(counters)
    first = min(spans, key=lambda e: e["ts"])
    assert first["ts"] == timers.spans[0].start / 1e3


def _panel_snvs(path):
    """The 0-based SNV positions of a haplotype VCF, from POS and SNVPOS."""
    snvs = []
    for line in pathlib.Path(path).read_text().splitlines():
        if not line.startswith("#"):
            fields = line.split("\t")
            info = dict(kv.split("=") for kv in fields[7].split(";"))
            snvs += [int(fields[1]) + int(s) - 2 for s in info["SNVPOS"].split(",")]
    return snvs


def _calls_in_sam(path, snvs):
    """The (record, SNV) pairs of a SAM file whose SNV lies in one of the
    record's M blocks."""
    n = 0
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith("@"):
            continue
        fields = line.split("\t")
        ref = int(fields[3]) - 1
        for ln, op in re.findall(r"(\d+)([MIDNSHP=X])", fields[5]):
            if op in "M=X":
                n += sum(ref <= p < ref + int(ln) for p in snvs)
            if op in "MDN=X":
                ref += int(ln)
    return n


def test_snv_calls_counter_counts_calls_before_mates_merge(dataset, monkeypatch, tmp_path):
    """``io.snv_calls`` of a ``call`` job equals the (read, SNV) pairs
    counted from the SAM records and the panel's SNVs.  The first sample's
    reads are written twice under one qname each (mates), so its calls
    double while its rows stay as many as its qnames."""
    bams = list(dataset["bams"])
    lines = pathlib.Path(bams[0]).read_text().splitlines()
    mates = tmp_path / "mates.sam"
    mates.write_text("\n".join(
        [x for x in lines if x.startswith("@")]
        + [x for x in lines if not x.startswith("@") for _ in range(2)]) + "\n")
    bams[0] = str(mates)
    monkeypatch.setenv("MCHAP_TIMING", "1")
    timers = timing.reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(_argv(dict(dataset, bams=bams), "call")) == 0
    records = parse_vcf_records(out.getvalue())
    snvs = _panel_snvs(dataset["haplotypes"])
    calls = [_calls_in_sam(path, snvs) for path in bams]
    assert calls[0] == 2 * _calls_in_sam(dataset["bams"][0], snvs) > 0
    assert timers.counters["io.snv_calls"] == sum(calls)
    rows = {s: sum(int(r["calls"][s]["RCOUNT"]) for r in records) for s in dataset["samples"]}
    first = dataset["samples"][0]
    assert rows[first] == sum(not x.startswith("@") for x in lines)
    assert timers.counters["io.reads_extracted"] == sum(rows.values())
    per_read = sum(calls) / sum(rows.values())
    assert f"io: {per_read:.4f} SNV calls per read extracted" in err.getvalue()


#: the spans of a ``call-pedigree`` block, with their parents
PARENT_PEDIGREE = dict(
    {name: PARENT[name] for name in (
        "read_loci", "block", "encode_reads", "io.read_extract", "io.alignment_load",
        "encoding.reads", "device_sampler", "device.launch", "device.sync",
        "device.trace_fetch", "summarize_format", "posterior.samples", "vcf.record")},
    **{"pedigree.prep": "device_sampler", "pedigree.incongruence": "posterior.samples",
       "pedigree.posterior": "posterior.samples"},
)


def test_call_pedigree_spans_and_counters(tmp_path, monkeypatch):
    """A ``call-pedigree`` block of 2 loci over 2 parents and 2 F1: its
    span tree, the host preparation's attributes, a PEDERR pass and the
    per-sample summaries inside each locus's ``posterior.samples``, a
    ``vcf.record`` per locus, and the pedigree counters."""
    from mchap_tpu_torch.ops.cuda_pedigree import Plan

    data = write_dataset(tmp_path, n_samples=4, n_loci=2, pedigree=True, seed=3)
    panel = write_haplotype_vcf(tmp_path / "haplotypes.vcf", data)
    steps, chains = 20, 2
    argv = ["mchap", "call-pedigree", "--bam", *data["bams"], "--ploidy", "4",
            "--reference", data["reference"], "--haplotypes", panel,
            "--sample-parents", data["pedigree"], "--mcmc-steps", str(steps),
            "--mcmc-burn", "5", "--device", "cpu", "--locus-batch", "2"]
    timers = _enabled(monkeypatch, tmp_path)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    records = parse_vcf_records(out.getvalue())
    assert len(records) == 2

    by_id = {s.id: s for s in timers.spans}
    assert {s.name for s in timers.spans} == set(PARENT_PEDIGREE)
    for s in timers.spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent == PARENT_PEDIGREE[s.name], (s.name, parent)
    assert [s.attrs for s in timers.spans if s.name == "pedigree.prep"] == [
        {"loci": 2, "samples": 4}]
    for name in ("posterior.samples", "pedigree.incongruence", "pedigree.posterior",
                 "vcf.record"):
        assert [s.attrs for s in timers.spans if s.name == name] == [
            {"locus": r["ID"]} for r in records]

    plan = Plan([4] * 4, [[-1, -1], [-1, -1], [0, 1], [0, 1]], [[2, 2]] * 4,
                [[0.0, 0.0]] * 4, [[0.01, 0.01]] * 4)
    runs = 2 * chains * steps  # loci x chains x steps
    counters = timers.counters
    assert counters["pedigree.sample_updates"] == runs * 4 * 4
    assert counters["pedigree.pair_swaps"] == runs * len(plan.pairs) == runs
    assert counters["pedigree.waves"] == len(plan.waves) > 0
    # one PEDERR pass per locus judges each kept state of each child
    kept = chains * (steps - 5)
    assert counters["pedigree.incongruence_checks"] == kept * 2 * len(records)


@pytest.mark.parametrize("tool", ["call", "assemble"])
def test_benchmark_span_readers_split_the_stages(dataset, tool, monkeypatch):
    """The six span readers of ``gpubench/metrics/`` on one job of the
    benchmark's own runner: each part of a stage within it."""
    from gpubench import jobs, run
    from gpubench.metrics import _span

    monkeypatch.setenv("MCHAP_TIMING", "0")
    job = jobs.run_job(_argv(dataset, tool)[1:], True)
    assert job["ok"], job["error"]
    job["loci"] = 3
    ctx = dict(jobs=[job])
    read = {name: run.load_metric(name).read(ctx) for name in (
        "encode_reads.ms_per_locus", "summarize_format.ms_per_locus",
        "io.alignment_load.ms_per_locus", "io.read_extract.ms_per_locus",
        "encoding.reads.ms_per_locus", "posterior.samples.ms_per_locus",
        "vcf.record.ms_per_locus", "device_sampler.host_ms_per_locus",
    )}
    assert all(v is not None and v > 0 for v in read.values()), read
    encode = read["io.alignment_load.ms_per_locus"] + read["io.read_extract.ms_per_locus"] \
        + read["encoding.reads.ms_per_locus"]
    assert encode <= read["encode_reads.ms_per_locus"]
    assert read["posterior.samples.ms_per_locus"] + read["vcf.record.ms_per_locus"] \
        <= read["summarize_format.ms_per_locus"]
    sync = _span.ms_per_locus(ctx, "device.sync")
    assert read["device_sampler.host_ms_per_locus"] == pytest.approx(
        _span.ms_per_locus(ctx, "device_sampler") - sync)
    # a program that opens none of the new spans, only the stages, reads None
    top = ("read_loci", "encode_reads", "device_sampler", "summarize_format")
    bare = dict(jobs=[dict(job, spans=[sp for sp in job["spans"] if sp[0] in top])])
    for name in ("io.read_extract.ms_per_locus", "device_sampler.host_ms_per_locus"):
        assert run.load_metric(name).read(bare) is None


# -- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: times a kernel under torch.profiler")


@pytest.mark.cuda
def test_kernel_interval_lies_inside_its_span(card, monkeypatch, tmp_path):
    """A kernel launched and waited for inside a span lies inside it on
    the profiler's clock, in the profiler's events and in its exported
    trace beside ``chrome_trace`` on the export's time base."""
    from torch.profiler import ProfilerActivity, profile

    timers = _enabled(monkeypatch, tmp_path)
    x = torch.randn(4096, 4096, device="cuda")
    (x @ x).sum().item()  # the library's set-up, outside the window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timing.stage("clock.check"):
            y = x @ x
            torch.cuda.synchronize()
    (span,) = [s for s in timers.spans if s.name == "clock.check"]
    kernels = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels and y.shape == x.shape
    k_start, k_end = min(k[1] for k in kernels), max(k[2] for k in kernels)
    print(f"span {span.end - span.start} ns; first kernel starts {k_start - span.start} ns"
          f" after the span, last ends {span.end - k_end} ns before its end; kernels"
          f" {[k[0][:40] for k in kernels]}")
    assert span.start <= k_start <= k_end <= span.end

    path = tmp_path / "profiler.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    base = exported.get("baseTimeNanoseconds", 0)
    ours = timers.chrome_trace(base_ns=base)
    (ev,) = [e for e in ours["traceEvents"] if e.get("name") == "clock.check"]
    device = [e for e in exported["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert device
    first = min(e["ts"] for e in device)
    last = max(e["ts"] + e["dur"] for e in device)
    print(f"export base {base} ns; span ts {ev['ts']:.3f} us dur {ev['dur']:.3f};"
          f" device events {first:.3f} .. {last:.3f} us")
    # both exports round to the nanosecond
    assert ev["ts"] - 0.001 <= first and last <= ev["ts"] + ev["dur"] + 0.001
