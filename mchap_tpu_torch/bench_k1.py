"""Time K1, the de novo sampler kernel, in several checkouts in one run.

Usage: python -m mchap_tpu_torch.bench_k1 DIR [DIR ...]

Each DIR is an unpacked checkout of this repository (``.`` for this
one).  The K1 libraries (flat, and ladder and prior) of the distinct
DIRs are built at once, one ``nvcc`` each; then, for each DIR in the
order given, a fresh Python process imports DIR's own
``mchap_tpu_torch`` and times its K1 with this checkout's
``chip_smoke.time_k1`` at ``chip_smoke.k1_shape``'s three shapes: D
(16,384 chains, P4, NB16, A2, R64, one rung, the flat prior), Q (D with
4 rungs and the prior) and the latency shape of phase C's launches
(440 problems x 2 chains, NB48, A3), with CUDA events.  Give the DIRs
as A B B A to see how far two runs of one checkout drift.  Prints the
card's name and power limit, each DIR's ptxas lines for K1's kernels,
each run's ms per step and a JSON summary.  Needs one GPU.
"""

import argparse
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ("D", "Q", "latency")
_BUILD = (
    "from concurrent.futures import ThreadPoolExecutor\n"
    "from mchap_tpu_torch.ops import cuda_denovo as K\n"
    "list(ThreadPoolExecutor(2).map(K.load_library, (False, True)))\n"
)
_TIME = (
    "import importlib.util, json, torch\n"
    "spec = importlib.util.spec_from_file_location('chip_smoke_bench', {path!r})\n"
    "cs = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(cs)\n"
    "dev = torch.device('cuda', 0)\n"
    "out = {{s: cs.time_k1(*cs.k1_shape(s, dev)) for s in {shapes!r}}}\n"
    "print('RESULT ' + json.dumps(out))\n"
)


def _run(code, root):
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"bench: {root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return proc.stdout


def _ptxas_lines(root, logs=("denovo_sampler.log", "denovo_sampler_ladder.log"),
                 kernels=r"(denovo_kernel|denovo_ladder_kernel|mutation_kernel)ILi(\d+)E"):
    """ptxas's register and stack lines for each instance of ``kernels``
    in the tree's build ``logs`` (by default K1's and K0's)."""
    lines = []
    for log in logs:
        kernel = None
        for line in (pathlib.Path(root) / ".build" / "kernels" / log).read_text().splitlines():
            m = re.search(kernels, line)
            if m and ("Compiling entry function" in line or "Function properties for" in line):
                kernel = f"{m.group(1)}<{m.group(2)}>"
            elif kernel and ("registers" in line or "stack frame" in line):
                lines.append(f"{kernel}: {line.split('info    :')[-1].strip()}")
    return lines


def bench(roots, build_code, time_code, shapes, ptxas_lines):
    """Build every distinct root's kernels at once with ``build_code``,
    print their ptxas lines, then run ``time_code`` (which prints
    ``RESULT`` and a JSON object of ms per step by shape) in each root in
    turn, in a fresh process each."""
    roots = [str(pathlib.Path(r).resolve()) for r in roots]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    distinct = list(dict.fromkeys(roots))
    with ThreadPoolExecutor(len(distinct)) as pool:
        list(pool.map(lambda r: _run(build_code, r), distinct))
    for root in distinct:
        for line in dict.fromkeys(ptxas_lines(root)):
            print(f"ptxas {root}: {line}", flush=True)
    runs = []
    for root in roots:
        out = _run(time_code, root)
        result = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
        print(f"{root}: " + ", ".join(f"{s} {result[s]:.4f}" for s in shapes)
              + " ms per step", flush=True)
        runs.append(dict(root=root, ms_per_step=result))
    print(json.dumps({"runs": runs}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    code = _TIME.format(path=str(HERE / "chip_smoke.py"), shapes=SHAPES)
    bench(args.roots, _BUILD, code, SHAPES, _ptxas_lines)


if __name__ == "__main__":
    main()
