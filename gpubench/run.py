"""The benchmark of ``mchap_tpu_torch``, the PyTorch/CUDA port, on NVIDIA GPUs.

Usage, from the root of a checkout:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is ``workloads/<cell>.json``,
which names its configuration, ``configs/<config>.json``.  A run:

1. writes ``pool`` datasets of the configuration's shape (``data.py``)
   under ``$TMPDIR/gpubench/<cell>/<seed>``;
2. warms up on one job (every kernel it needs is built or loaded);
3. opens the window and runs jobs back to back, one client in a closed
   loop, each ``mchap <tool>`` in process on a dataset of the pool with
   an MCMC seed: the window's jobs go round the pool again and again, in
   an order drawn from ``--seed`` (``pool_order``), and a job that starts
   before ``--seconds`` have passed runs to its end and counts.  The
   datasets and each round's MCMC seeds are the same for every seed
   (``POOL_SEED``, ``mcmc_seed``), so every run does the same work;
4. with ``--trace 1``, runs the window under ``torch.profiler`` and the
   program's stage timers, and reads each per-layer metric that
   ``BENCHMARK.json`` gives this cell from ``metrics/<name>.py``;
5. judges every locus of every window job against the plain reference
   through the configuration's tool file (``tools/<tool>.py``, built on
   ``reference/``) and prints the result as the last line.

``setup_s`` runs from the process's start to the window's opening;
``loci_per_s`` is the loci of all window jobs over the time from the
opening to the end of the last job.  The run fails, printing no result,
without a CUDA device, without the port, or when ``jax``, ``jaxlib``,
``flax`` or ``mchap_tpu`` is found loaded once the window has closed.
"""

import argparse
import gc
import importlib.util
import json
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mchap_tpu"}


def boot_seconds():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start():
    """When this process started, on ``boot_seconds``'s clock."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``mchap_tpu_torch`` is not ``mchap_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def load_cell(name):
    """The cell's workload file over its configuration's file."""
    work = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cell = json.loads((HERE / "configs" / f"{work['config']}.json").read_text())
    dataset = dict(cell["dataset"], **work.pop("dataset", {}))
    cell.update(work, dataset=dataset)
    cell["name"] = name
    return apply_options(cell)


# options of the tools whose values the judge and the work counts read
OPTION_SETTINGS = {"--mcmc-steps": ("steps", int), "--mcmc-burn": ("burn", int),
                   "--mcmc-chains": ("chains", int), "--use-dirmul-prior": ("inbreeding", float),
                   "--haplotype-posterior-threshold": ("haplotype_posterior_threshold", float)}


def apply_options(cell):
    """Set the sampler settings that a cell's ``options`` change over its
    configuration's defaults, so that each is stated once, as the
    program is given it."""
    options = cell["options"]
    for i, word in enumerate(options):
        if word in OPTION_SETTINGS:
            key, kind = OPTION_SETTINGS[word]
            cell[key] = kind(options[i + 1])
        elif word == "--mcmc-temperatures":
            values = []
            for value in options[i + 1:]:
                if value.startswith("--"):
                    break
                values.append(float(value))
            cell["temperatures"] = values
    return cell


def _load(kind, name):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name):
    return _load("metrics", name)


# what a tool file (``tools/<tool>.py``) gives the harness: the program's block
# fit it taps (``SITE``) and the tap, its reference, judge and problems, the
# metric that counts its sampler work, and for the fault tests the steps of a
# small run and its samplers frozen at their initial state
TOOL_INTERFACE = ("SITE", "tap", "Reference", "judge", "problems", "WORK", "SMALL_RUN",
                  "unchanged_samplers")
# what a tool file may give of its own, else the shared judge's (``reference/judge.py``)
TOOL_SHARED = ("NUMBERS", "REQUIRED", "answers_from_vcf", "control", "merge")


def load_tool(name):
    """The tool file of a configuration's ``tool``, ``tools/<name>.py``,
    with each name of ``TOOL_SHARED`` that it does not give taken from
    ``reference/judge.py``; raises AttributeError, naming them, where it
    lacks part of ``TOOL_INTERFACE``."""
    from gpubench.reference import judge

    module = _load("tools", name)
    missing = [k for k in TOOL_INTERFACE if not hasattr(module, k)]
    if missing:
        raise AttributeError(f"gpubench: tools/{name}.py lacks {', '.join(missing)}")
    for k in TOOL_SHARED:
        if not hasattr(module, k):
            setattr(module, k, getattr(judge, k))
    return module


def cell_metrics(bench, cell_name, kind):
    """This cell's entries of ``bench[kind]``."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


# the seed of every run's datasets and jobs: a run's own seed orders the jobs
# and draws the states the tap keeps, but changes neither the datasets nor the
# MCMC seeds, since how long a job takes depends on both (in ``assemble``, on
# how many of its problems take the tabulation's overflow route), and so a
# rate over jobs drawn from each run's seed would swing with the seed
POOL_SEED = 0


def write_pool(directory, cell, n):
    """The cell's ``n`` datasets, from ``POOL_SEED``, one process each (the
    writer is host Python)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gpubench import data

    shutil.rmtree(directory, ignore_errors=True)
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [ex.submit(data.write_pool_one, directory, cell["dataset"], POOL_SEED, i)
                   for i in range(n)]
        return [f.result() for f in futures]


def pool_order(seed, n):
    """The order, drawn from ``seed``, in which a run goes through its
    ``n`` datasets, again and again."""
    import numpy as np

    return np.random.default_rng([seed, 0x90D]).permutation(n).tolist()


def mcmc_seed(dataset, round_, n):
    """The MCMC seed of a run's ``round_``-th job on dataset ``dataset`` of
    its ``n``; the warm-up is round -1."""
    return POOL_SEED + 1 + (round_ + 1) * n + dataset


def job_argv(cell, dataset, mcmc_seed, device=None):
    samples = set(cell["samples"])
    bams = [b for s, b in zip(dataset["samples"], dataset["bams"]) if s in samples]
    argv = []
    for word in cell["argv"]:
        if word == "{bams}":
            argv.extend(bams)
        elif word.startswith("{"):
            argv.append(str(dataset[word[1:-1]]))
        else:
            argv.append(word)
    argv += ["--mcmc-seed", str(mcmc_seed), *cell["options"]]
    if device is not None:
        argv += ["--device", device]
    return argv


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def measure(cell, seed, seconds, traced, started, device=None, metrics=(), log=print):
    """Set up, warm up, run the window, judge it.  Returns the result's
    dict (without ``checks``) and the checks, or raises.  ``device`` None
    is the card; tests pass "cpu" to drive the rest of a run without one."""
    import torch

    from gpubench import jobs, trace

    tool = load_tool(cell["tool"])
    on_card = device is None
    tmp = pathlib.Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    directory = tmp / "gpubench" / cell["name"] / str(seed)
    t_write = boot_seconds()
    pool = write_pool(directory, cell, cell["pool"])
    order = pool_order(seed, len(pool))
    t_warm = boot_seconds()
    names = pool[0]["samples"]
    cell["samples"] = names if cell["samples"] == "all" else [names[i] for i in cell["samples"]]

    warm = jobs.run_job(job_argv(cell, pool[0], mcmc_seed(0, -1, len(pool)), device), traced)
    log(f"gpubench: warm-up job wall {warm['wall_s']:.4f} s ok {warm['ok']}")
    if not warm["ok"]:
        log(f"gpubench: warm-up error: {warm['error']}")
    prof = trace.start() if traced and on_card else None
    t_open = time.perf_counter()
    ns_open = time.time_ns()
    setup_s = boot_seconds() - started
    log(f"gpubench: set-up {setup_s:.4f} s: to the datasets {t_write - started:.4f} s,"
        f" datasets {t_warm - t_write:.4f} s, warm-up and the rest {started + setup_s - t_warm:.4f} s")
    window = []
    while True:
        i = len(window)
        k = order[i % len(pool)]
        with tool.tap(seed + i + 1, cell["burn"]) as record:
            job = jobs.run_job(job_argv(cell, pool[k], mcmc_seed(k, i // len(pool), len(pool)),
                                        device), traced)
        job.update(dataset=k, record=record)
        window.append(job)
        if time.perf_counter() - t_open >= seconds:
            break
    span = time.perf_counter() - t_open
    ns_close = time.time_ns()
    events = trace.device_events(prof) if prof is not None else []
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    refs = [tool.Reference(d, cell) for d in pool]
    loci = len(refs[0].loci)
    numbers, failed = [], 0
    for i, job in enumerate(window, 1):
        ref = refs[job["dataset"]]
        answers, bad_summary = tool.answers_from_vcf(ref, job["vcf"]) if job["ok"] else ({}, ())
        n, worst = tool.judge(ref, answers, job["record"], bad_summary)
        numbers.append(n)
        bad = {name for (name, _), a in answers.items() if a is None}
        failed += loci if not job["ok"] else len(bad)
        job["loci"] = loci
        log(f"gpubench: job {i} dataset {job['dataset']} loci {loci} wall {job['wall_s']:.6f} s"
            f" ok {job['ok']} routes {json.dumps(job['paths'])}"
            f" launches {json.dumps(job['launches'])} numbers {json.dumps(n)}"
            f" worst {json.dumps(worst)}")
        if job["error"]:
            log(f"gpubench: job {i} error: {job['error']}")
    merged = tool.merge(numbers)
    log(f"gpubench: numbers {json.dumps(merged)}")
    checks = {k: dict(value=merged[k], limit=limit) for k, limit in cell["limits"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    usage = resource.getrusage(resource.RUSAGE_SELF)
    log(f"gpubench: window {span:.6f} s, {len(window)} jobs, {loci * len(window)} loci;"
        f" process CPU {usage.ru_utime + usage.ru_stime:.3f} s;"
        f" max_memory_allocated {memory_peak}; card {card_line() if on_card else 'none'}")
    result = dict(
        correct=correct, attempted=loci * len(window), failed=failed, metrics={},
        device=dict(platform="gpu", kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                    count=torch.cuda.device_count() if on_card else 0,
                    memory_peak_bytes=memory_peak),
    )
    if not traced:
        result["metrics"]["loci_per_s"] = dict(value=loci * len(window) / span, unit="loci/s")
        result["metrics"]["setup_s"] = dict(value=setup_s, unit="s")
    else:
        for job in window:
            job["problems"] = tool.problems(refs[job["dataset"]], cell)
        busy = trace.busy_intervals(events, ns_open, ns_close)
        busy_s = sum(e - s for s, e in busy) / 1e9
        ctx = dict(cell=cell, jobs=window, window_s=(ns_close - ns_open) / 1e9,
                   busy_s=busy_s if on_card else None,
                   kernel_seconds=lambda pattern: trace.kernel_seconds(events, pattern),
                   card=result["device"]["kind"])
        for m in metrics:
            module = load_metric(m["name"])
            value = module.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value, unit=module.UNIT)
        result["device"].update(busy_s=busy_s, window_s=ctx["window_s"])
        spans = [sp for job in window for sp in job["spans"]]
        result["breakdown"] = trace.breakdown(events, spans, ns_open, ns_close)
    shutil.rmtree(directory, ignore_errors=True)
    return result, checks


def main(argv=None):
    started = process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        print(f"gpubench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    # the port's kernels build into its own .build/kernels/; any other
    # build or kernel cache stays in the checkout too, at a fixed path
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".build" / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"gpubench: needs {spec['chips']} CUDA device(s), found"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("mchap_tpu_torch") is None:
        print("gpubench: the program (mchap_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    kind = "per_layer" if args.trace else "end_to_end"
    result, checks = measure(
        cell, args.seed, args.seconds, bool(args.trace), started,
        metrics=cell_metrics(bench, args.workload, kind),
    )
    return finish(result, checks, forbidden_modules())


def finish(result, checks, forbidden):
    """Print the numbers compared beside their limits as the last lines of
    standard error and the result as the last line of standard output,
    the checks under the last key; or, with a forbidden module loaded,
    no result.  Returns the exit code."""
    if forbidden:
        print(f"gpubench: found loaded after the window: {', '.join(forbidden)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(dict(result, checks=checks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
