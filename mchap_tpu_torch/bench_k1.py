"""Time K1, the de novo sampler kernel, in several checkouts in one run.

Usage: python -m mchap_tpu_torch.bench_k1 DIR [DIR ...]

Each DIR is an unpacked checkout of this repository (``.`` for this
one).  The K1 libraries of the distinct DIRs are built at once, one
``nvcc`` each; then, for each DIR in the order given, a fresh Python
process imports DIR's own ``chip_smoke.py`` and ``mchap_tpu_torch`` and
runs ``chip_smoke.phase_d``: 16,384 chains x 200 steps, P4, R64, NB16,
A2, the flat prior and one rung, timed with CUDA events.  Give the
DIRs as A B B A to see how far two runs of one checkout drift.  Prints
the card's name and power limit, each DIR's ptxas lines for K1's
kernels, each run's ms per step and a JSON summary.  Needs one GPU.
"""

import argparse
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_BUILD = "from mchap_tpu_torch.ops import cuda_denovo as K; K.load_library()"
_PHASE_D = (
    "import json, torch, chip_smoke\n"
    "card = chip_smoke._card()\n"
    "out = chip_smoke.phase_d(torch.device('cuda', 0), card)\n"
    "print('RESULT ' + json.dumps(out))\n"
)


def _run(code, root):
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"bench_k1: {root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return proc.stdout


def _ptxas_lines(root):
    """ptxas's register and stack lines for the P4 instance of phase D's
    kernel, ``denovo_kernel<4>``."""
    log = pathlib.Path(root) / ".build" / "kernels" / "denovo_sampler.log"
    lines, kernel = [], None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            kernel = "denovo_kernel" if "denovo_kernelILi4E" in line else None
        elif kernel and ("registers" in line or "stack frame" in line):
            lines.append(f"{kernel}<4>: {line.split('info    :')[-1].strip()}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    roots = [str(pathlib.Path(r).resolve()) for r in args.roots]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    distinct = list(dict.fromkeys(roots))
    with ThreadPoolExecutor(len(distinct)) as pool:
        list(pool.map(lambda r: _run(_BUILD, r), distinct))
    for root in distinct:
        for line in _ptxas_lines(root):
            print(f"ptxas {root}: {line}", flush=True)
    runs = []
    for root in roots:
        out = _run(_PHASE_D, root)
        result = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
        print(f"{root}: {result['ms']:.4f} ms per step", flush=True)
        runs.append(dict(root=root, ms_per_step=result["ms"]))
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()
