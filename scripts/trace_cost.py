"""The cost of recording the port's spans, on one benchmark cell's data.

On a machine with a card, from the root of a checkout:

    python3 scripts/trace_cost.py --workload call.biparental --seed 7 --pairs 5

writes the cell's first dataset (``gpubench/data.py``), warms up on one
job, then runs ``2 x pairs`` jobs of the cell's tool on that dataset and
one sampler seed (so every job does the same work) in one process, in
turns (off, on, on, off, ...): recording off, and recording on as the
benchmark's traced run has it (``MCHAP_TIMING=1``, every span also kept
by ``gpubench.jobs.run_job``), with no profiler.  Then it times spans
alone: ``SPANS`` nested spans with attributes opened through the same
wrapper, recording on and off.  Prints a JSON line per job (wall s,
spans) and a last line with each side's median wall, spans per job and
the µs a span costs.  ``--device cpu`` runs it here at the cell's size,
slowly.
"""

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gpubench import jobs, run  # noqa: E402
from mchap_tpu_torch.utils import timing  # noqa: E402

SPANS = 100_000


def span_cost_us(on):
    """µs per span (a parent and a child with attributes, in turn)
    opened through a wrapper of ``TIMERS.stage`` as ``jobs.run_job``
    installs it, with recording ``on`` or off."""
    os.environ["MCHAP_TIMING"] = "1" if on else "0"
    timers = timing.reset()
    if on:
        program_stage, kept = timers.stage, []

        @contextlib.contextmanager
        def stage(name):
            t0 = time.time_ns()
            try:
                with program_stage(name):
                    yield
            finally:
                kept.append((name, t0, time.time_ns()))

        timers.stage = stage
    t0 = time.perf_counter()
    for i in range(SPANS // 2):
        with timing.stage("io.read_extract", locus="locus1", sample="sample1"):
            with timing.stage("io.alignment_load", file="sample1.sam"):
                pass
    return 1e6 * (time.perf_counter() - t0) / SPANS


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    cell = run.load_cell(args.workload)
    directory = pathlib.Path(tempfile.mkdtemp(prefix="trace_cost_"))
    try:
        (dataset,) = run.write_pool(directory, cell, args.seed, 1)
        names = dataset["samples"]
        cell["samples"] = names if cell["samples"] == "all" else [names[i] for i in cell["samples"]]

        def job(traced):
            out = jobs.run_job(run.job_argv(cell, dataset, args.seed, args.device), traced)
            if not out["ok"]:
                raise RuntimeError(out["error"])
            return dict(traced=traced, wall_s=out["wall_s"], spans=len(out["spans"]))

        job(False)  # warm-up: kernels built or loaded
        sides = {False: [], True: []}
        for i in range(2 * args.pairs):
            traced = i % 4 in (1, 2)
            line = job(traced)
            sides[traced].append(line)
            print(json.dumps(line), flush=True)
        off = statistics.median(j["wall_s"] for j in sides[False])
        on = statistics.median(j["wall_s"] for j in sides[True])
        print(json.dumps(dict(
            workload=args.workload, seed=args.seed, jobs_per_side=args.pairs,
            median_wall_off_s=off, median_wall_on_s=on, on_over_off=on / off,
            spans_per_job=statistics.median(j["spans"] for j in sides[True]),
            span_us_on=span_cost_us(True), span_us_off=span_cost_us(False),
            card=run.card_line() if args.device is None else args.device,
        )), flush=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


if __name__ == "__main__":
    main()
