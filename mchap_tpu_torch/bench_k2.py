"""Time K2, the calling sampler kernel, in several checkouts in one run.

Usage: python -m mchap_tpu_torch.bench_k2 DIR [DIR ...]

Each DIR is an unpacked checkout of this repository (``.`` for this
one).  The K2 libraries of the distinct DIRs are built at once, one
``nvcc`` each; then, for each DIR in the order given, a fresh Python
process imports DIR's own ``mchap_tpu_torch`` and times its K2 with this
checkout's ``chip_smoke.time_k2`` at ``chip_smoke.k2_shape``'s two
shapes: H (65,536 chains, P4, R64, a 16-haplotype panel; 500 steps) and
V, the latency shape of phase G's launch (``LATENCY_K2``: 440 problems x
2 chains, R16, H6; 2000 steps), with CUDA events around the launches
alone (``time_k2`` calls each tree's ``_launch``, past its wrapper's
input checks).  Give the DIRs as A B B
A to see how far two runs of one checkout drift.  Prints the card's name
and power limit, each DIR's ptxas lines for K2's kernel, each run's ms
per step and a JSON summary.  Needs one GPU.  Shares its method with
``bench_k1``.
"""

import argparse
import functools

from mchap_tpu_torch.bench_k1 import HERE, _ptxas_lines, bench

SHAPES = {"H": 500, "V": 2000}  # label: steps per launch
_BUILD = "from mchap_tpu_torch.ops import cuda_calling as KC\nKC.load_library()\n"
_TIME = (
    "import importlib.util, json, torch\n"
    "spec = importlib.util.spec_from_file_location('chip_smoke_bench', {path!r})\n"
    "cs = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(cs)\n"
    "dev = torch.device('cuda', 0)\n"
    "out = {{s: cs.time_k2(*cs.k2_shape(s, dev), steps=n) for s, n in {shapes!r}.items()}}\n"
    "print('RESULT ' + json.dumps(out))\n"
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    code = _TIME.format(path=str(HERE / "chip_smoke.py"), shapes=SHAPES)
    ptxas = functools.partial(_ptxas_lines, logs=("calling_sampler.log",),
                              kernels=r"(calling_kernel)ILi(\d+)E")
    bench(args.roots, _BUILD, code, list(SHAPES), ptxas)


if __name__ == "__main__":
    main()
