"""Phase W's ``assemble`` run under several chain and step settings.

Usage: python -m mchap_tpu_torch.bench_w [CHAINS,STEPS,BURN ...]

Writes phase C's dataset (``chip_smoke.c_dataset``: 22 tetraploid
samples x 20 loci, 5 of them triallelic) and runs ``mchap assemble
--use-dirmul-prior FILE`` on it in process, the first sample at F = 0
and the rest at 0.1, so that every block takes the torch de novo
sampler, once per setting (default: 4,300,150 4,240,120 6,200,100
8,160,80 2,600,300; the first run also pays the process's warm-up).
Prints the card's name and power limit, and per setting its GT == truth
share over the 440 sample-calls, wall, sampler seconds and ms per step,
and the stage split.  This chose ``chip_smoke.W_STEPS``.  Needs one GPU.
"""

import argparse
import sys

from mchap_tpu_torch.bench_k1 import HERE

DEFAULT = ["4,300,150", "4,240,120", "6,200,100", "8,160,80", "2,600,300"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings", nargs="*", default=DEFAULT, help="CHAINS,STEPS,BURN")
    args = ap.parse_args(argv)
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
        sampler_s = timers.stages.get("device.torch_sampler", float("nan"))
        print(f"chains {chains} steps {steps} burn {burn}: rc {rc}, {len(records)} records,"
              f" routes {routes}, sampler calls {len(calls)} shapes"
              f" {[tuple(c[0][1].shape) for c in calls]}, GT == truth {agree}/{total} ="
              f" {agree / max(total, 1):.4f}; wall {wall:.2f} s, sampler {sampler_s:.2f} s ="
              f" {1e3 * sampler_s / int(steps):.2f} ms per step", flush=True)
        for line in timers.summary_lines():
            print("   ", line, flush=True)


if __name__ == "__main__":
    main()
