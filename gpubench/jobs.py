"""One job of a cell: one in-process call of the port's CLI entry point.

Follows ``chip_smoke._run_cli`` (``chip_smoke.py`` at commit
65387dc1a014974af8eb9ddb0164675d39e14aad): the route tally
(``utils.fallback.PATHS``), the kernels' launch counters and the stage
timers and counters (``utils.timing``) are reset just before the call
and read just after it.  The stage timers and counters run only where
``MCHAP_TIMING`` asks for them (the traced run); then each stage is also
kept as a span, on the clock of the profiler's trace (``time.time_ns``),
so that idle gaps on the device can be put down to what the host was
doing.
"""

import contextlib
import io
import os
import time
import traceback

# the kernels' wrappers, each with a ``.launches`` counter
LAUNCH_COUNTERS = (
    ("cuda_denovo", "denovo_sampler"),
    ("cuda_denovo", "mutation_sweep"),
    ("cuda_calling", "calling_sampler"),
    ("cuda_pedigree", "pedigree_sampler"),
    ("cuda_denovo_route", "denovo_route_sampler"),
)


def _counters():
    import importlib

    for module, name in LAUNCH_COUNTERS:
        yield name, getattr(importlib.import_module(f"mchap_tpu_torch.ops.{module}"), name)


def run_job(argv, timed_stages):
    """Run ``mchap <argv>`` in process.  Returns a dict: ``ok``, ``vcf``
    (standard output), ``wall_s`` (the benchmark's clock, the job's
    device work synchronised), ``stages`` (s per stage, with
    ``timed_stages``), ``spans`` ((name, start ns, end ns)), ``paths``,
    ``launches`` and ``error`` (a traceback, or None)."""
    import torch

    from mchap_tpu_torch.application.cli import main
    from mchap_tpu_torch.utils import fallback, timing

    os.environ["MCHAP_TIMING"] = "1" if timed_stages else "0"
    timers = timing.reset()
    spans = []
    if timed_stages:
        program_stage = timers.stage

        @contextlib.contextmanager
        def stage(name):
            t0 = time.time_ns()
            try:
                with program_stage(name):
                    yield
            finally:
                spans.append((name, t0, time.time_ns()))

        timers.stage = stage
    fallback.PATHS.clear()
    for _, fn in _counters():
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    error = None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["mchap", *argv])
        if rc != 0:
            error = f"exit code {rc}: {err.getvalue()[-2000:]}"
    except Exception:  # a job that raises fails its loci; the run goes on
        error = traceback.format_exc()[-4000:]
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(
        ok=error is None, vcf=out.getvalue(), wall_s=wall, stages=dict(timers.stages),
        spans=spans, counters=dict(timers.counters),
        paths={f"{site}={path}": n for (site, path), n in fallback.PATHS.items()},
        launches={name: fn.launches for name, fn in _counters()}, error=error,
    )
