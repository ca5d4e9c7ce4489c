"""Phase W's ``assemble`` run under several chain and step settings, or
in several checkouts.

Usage: python -m mchap_tpu_torch.bench_w [CHAINS,STEPS,BURN ...]
       python -m mchap_tpu_torch.bench_w --roots DIR [DIR ...]

Writes phase C's dataset (``chip_smoke.c_dataset``: 22 tetraploid
samples x 20 loci, 5 of them triallelic) and runs ``mchap assemble
--use-dirmul-prior FILE`` on it in process, the first sample at F = 0
and the rest at 0.1, so that every block takes the torch de novo
route (K4 on the card since it was ported; before, its plain version),
once per setting (default: 4,300,150 4,240,120 6,200,100
8,160,80 2,600,300; the first run also pays the process's warm-up).
Prints the card's name and power limit, and per setting its GT == truth
share over the 440 sample-calls, wall, sampler seconds and ms per step,
and the stage split.  This chose ``chip_smoke.W_STEPS``.

With ``--roots``, each DIR is an unpacked checkout of this repository
(``.`` for this one): for each in the order given, a fresh Python process
in DIR runs DIR's own ``chip_smoke.phase_w_assemble`` (phase W's
``assemble`` at ``W_STEPS``, then the route's ms per step at its
largest call's shape: K4's where DIR has it, built before the run, and
the plain version's eager and through its CUDA graph) on DIR's copy of
phase C's dataset.  Give the DIRs as A B B A to see how far two runs of
one checkout drift.  Needs one GPU.
"""

import argparse
import json
import subprocess
import sys

from mchap_tpu_torch.bench_k1 import HERE, _run

DEFAULT = ["4,300,150", "4,240,120", "6,200,100", "8,160,80", "2,600,300"]
_ROOT_RUN = (
    "import json, sys, torch\n"
    "sys.path[:0] = ['.', 'tests']\n"
    "import chip_smoke as cs\n"
    "try:  # K4, where the checkout has it, is built before the timed run\n"
    "    from mchap_tpu_torch.ops import cuda_denovo_route\n"
    "    cuda_denovo_route.load_library()\n"
    "except ImportError:\n"
    "    pass\n"
    "out = cs.phase_w_assemble(torch.device('cuda', 0), cs.c_dataset())\n"
    "print('RESULT ' + json.dumps({k: v for k, v in out.items()\n"
    "                              if k not in ('route_calls', 'launches')}))\n"
)


def bench_roots(roots):
    """Phase W's ``assemble`` and sampler timing in each checkout of
    ``roots`` in turn, each with its own code, in a fresh process each."""
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    runs = []
    for root in roots:
        out = _run(_ROOT_RUN, root)
        for line in out.splitlines():
            if line.startswith("phase W"):  # its results and its stage split
                print(f"{root}: {line}", flush=True)
        result = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
        runs.append(dict(root=root, **result))
    print(json.dumps({"runs": runs}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings", nargs="*", default=DEFAULT, help="CHAINS,STEPS,BURN")
    ap.add_argument("--roots", nargs="+", metavar="DIR", help="checkouts to run in turn")
    args = ap.parse_args(argv)
    if args.roots:
        bench_roots(args.roots)
        return
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "tests"))
    import chip_smoke as cs
    from test_torch_fixtures import parse_vcf_records

    from mchap_tpu_torch.utils import fallback

    print(cs._card_line(), flush=True)
    data = cs.c_dataset()
    path = cs.WORK / "assemble" / "inbreeding.txt"
    path.write_text("".join(f"{s}\t{0.1 if i else 0.0}\n"
                            for i, s in enumerate(data["samples"])))
    for setting in args.settings:
        chains, steps, burn = setting.split(",")
        argv = ["mchap", "assemble", "--bam", *data["bams"], "--ploidy", "4",
                "--targets", data["targets"], "--variants", data["variants"],
                "--reference", data["reference"], "--use-dirmul-prior", str(path),
                "--mcmc-chains", chains, "--mcmc-steps", steps, "--mcmc-burn", burn]
        with cs._denovo_sampler_calls() as calls:
            rc, vcf, wall, _, timers = cs._run_cli(argv)
        records = parse_vcf_records(vcf)
        agree, total = cs._truth_agreement(records, data["truth"])
        routes = sorted(p for (site, p) in fallback.PATHS if site == "denovo")
        # the torch route's launches and the wait for them: the only sampler here
        sampler_s = sum(timers.stages.get(k, float("nan")) for k in ("device.launch", "device.sync"))
        print(f"chains {chains} steps {steps} burn {burn}: rc {rc}, {len(records)} records,"
              f" routes {routes}, sampler calls {len(calls)} shapes"
              f" {[tuple(c[0][2].shape) for c in calls]}, GT == truth {agree}/{total} ="
              f" {agree / max(total, 1):.4f}; wall {wall:.2f} s, sampler {sampler_s:.2f} s ="
              f" {1e3 * sampler_s / int(steps):.2f} ms per step", flush=True)
        for line in timers.summary_lines():
            print("   ", line, flush=True)


if __name__ == "__main__":
    main()
