"""Start N local processes joined as one process group.

Port of ``scripts/launch_multihost.py``'s same-machine launcher.

    python -m mchap_tpu_torch.parallel.launch --nproc 2 call --haplotypes panel.vcf ...

runs ``python -m mchap_tpu_torch call ...`` in two processes with
``MCHAP_DISTRIBUTED=localhost:<port>,2,<rank>`` and ``LOCAL_RANK`` set:
each rank runs its share of every block on ``cuda:(rank % cards)`` (or
the CPU with ``--device cpu``), every rank gathers the whole result,
and only rank 0 writes the VCF.  On a cluster, run the same command on
every host with ``MCHAP_DISTRIBUTED=<host0>:<port>,<world>,<rank>``, or
under ``torchrun`` with ``MCHAP_DISTRIBUTED=1``.

    python -m mchap_tpu_torch.parallel.launch --smoke

starts two CPU processes that run ``fit_calling_multi``'s K2 route with
every draw pinned, and checks that both ranks hold the same genotypes
and that only rank 0 is the output process.
"""

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mchap_tpu_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parents[2]


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, nproc=2, port=None, stdout=None, timeout=None, env=None):
    """Run ``python <argv>`` in ``nproc`` processes joined through
    ``MCHAP_DISTRIBUTED``; returns their exit codes in rank order.

    ``stdout``: a path per rank for its standard output (None: this
    process's).  As soon as one process exits non-zero the others are
    killed (they would wait for it in the group's next collective), and
    their codes are those of the kill; if they have not all ended within
    ``timeout`` seconds, every process is killed and
    ``subprocess.TimeoutExpired`` raised.
    """
    port = port or free_port()
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [base.get("PYTHONPATH")] if p]
    )
    procs, files = [], []
    try:
        for rank in range(nproc):
            rank_env = dict(base, MCHAP_DISTRIBUTED=f"localhost:{port},{nproc},{rank}",
                            LOCAL_RANK=str(rank))
            out = None
            if stdout is not None:
                out = open(stdout[rank], "w")
                files.append(out)
            procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env, stdout=out))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(argv, timeout)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return [p.returncode for p in procs]


def smoke_problems():
    """Five small calling problems (a 3-haplotype panel, tetraploid)."""
    from mchap_tpu_torch.testing import simulate_reads

    haps = np.array([[0, 0, 0], [0, 1, 1], [1, 1, 1]], np.int8)
    problems = []
    for i in range(5):
        reads = simulate_reads(haps[np.array([0, 1, 1, 2])], n_alleles=2,
                               n_reads=8 + 4 * i, errors=False, seed=i)
        problems.append(dict(reads=reads, counts=np.ones(len(reads)), haplotypes=haps))
    return problems


def smoke_fit(problems, devices="auto"):
    """``fit_calling_multi``'s K2 route on the CPU, every draw pinned at
    0.3: genotypes [B, chains, steps, P] of the problems."""
    from mchap_tpu_torch.models.assemble import pad_reads_bucket
    from mchap_tpu_torch.models.calling import _fit_batch_kernel
    from mchap_tpu_torch.ops.likelihood import prepare_reads, read_hap_loglik

    rh = [read_hap_loglik(prepare_reads(p["reads"]), p["haplotypes"]).numpy() for p in problems]
    read_hap, counts = pad_reads_bucket(rh, [p["counts"] for p in problems], fill=0.0)
    n_valid = [len(p["haplotypes"]) for p in problems]
    traces = _fit_batch_kernel(read_hap, counts, 4, 20, 2, 3, n_valid,
                               device=torch.device("cpu"), pinned_noise=0.3, devices=devices)
    return np.stack([t.genotypes for t in traces])


def _smoke_worker(out_dir):
    torch.set_num_threads(1)
    if not distributed.maybe_initialize():
        raise RuntimeError("MCHAP_DISTRIBUTED is not set")
    rank, world = distributed.world()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), genotypes=smoke_fit(smoke_problems()),
             meta=np.array([rank, world, int(distributed.is_output_process())]))


def smoke(nproc=2, timeout=120):
    """``nproc`` CPU ranks fit the smoke problems; returns rank 0's
    genotypes after checking that every rank holds the same and that
    only rank 0 is the output process."""
    env = {k: v for k, v in os.environ.items() if k != "MCHAP_EMIT_ALL_HOSTS"}
    with tempfile.TemporaryDirectory() as tmp:
        codes = launch(["-m", "mchap_tpu_torch.parallel.launch", "--smoke-worker", tmp],
                       nproc, timeout=timeout, env=env)
        if any(codes):
            raise RuntimeError(f"smoke ranks exited with {codes}")
        results = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in range(nproc)]
        for r, d in enumerate(results):
            if list(d["meta"]) != [r, nproc, int(r == 0)]:
                raise RuntimeError(f"rank {r}: (rank, world, output) {list(d['meta'])}")
            if not np.array_equal(d["genotypes"], results[0]["genotypes"]):
                raise RuntimeError(f"rank {r} gathered other genotypes than rank 0")
        return results[0]["genotypes"]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run `python -m mchap_tpu_torch TOOL ...` in N local processes "
        "joined as one process group.")
    parser.add_argument("--nproc", type=int, default=2, help="processes (default 2)")
    parser.add_argument("--port", type=int, default=None, help="rendezvous port (default: a free one)")
    parser.add_argument("--smoke", action="store_true", help="run the two-process CPU check")
    parser.add_argument("--smoke-worker", metavar="OUT", help=argparse.SUPPRESS)
    parser.add_argument("tool", nargs=argparse.REMAINDER, help="the mchap tool and its arguments")
    args = parser.parse_args(argv)
    if args.smoke_worker:
        _smoke_worker(args.smoke_worker)
        return 0
    if args.smoke:
        smoke(args.nproc)
        print(f"smoke OK: {args.nproc} processes, identical gathered results, "
              "rank 0 the only output process")
        return 0
    if not args.tool:
        parser.error("name a tool to run, or --smoke")
    codes = launch(["-m", "mchap_tpu_torch", *args.tool], args.nproc, args.port)
    if any(codes):
        print(f"ranks' exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
