"""The precision control of a cell: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configuration's float32, judged like a run of the program.

Usage, from the root of a checkout:

    python3 -m gpubench.control --workload <cell> [--device cuda]

It writes the datasets that every run of the cell writes, whatever its
seed (``run.POOL_SEED``), answers every (locus, sample) of each with the
bfloat16 reference's posterior mode, its probability and its
log-likelihood (the tool file's ``control``), and prints the numbers the
run would compare as one JSON line.  It draws nothing, so it reads the
same on every call.  A limit has to sit below what the control reads in
at least one number.
"""

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile


def control_numbers(cell, device="cpu"):
    from gpubench import run

    tool = run.load_tool(cell["tool"])
    directory = (pathlib.Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
                 / "gpubench-control" / cell["name"])
    pool = run.write_pool(directory, cell, cell["pool"])
    names = pool[0]["samples"]
    cell = dict(cell, samples=names if cell["samples"] == "all" else [names[i] for i in cell["samples"]])
    numbers, worst = [], []
    for d in pool:
        ref = tool.Reference(d, cell)
        n, w = tool.judge(ref, *tool.control(ref, device=device))
        numbers.append(n)
        worst.append(w)
    shutil.rmtree(directory, ignore_errors=True)
    return tool.merge(numbers), worst


def main(argv=None):
    from gpubench import run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    cell = run.load_cell(args.workload)
    numbers, worst = control_numbers(cell, args.device)
    print(json.dumps(dict(workload=args.workload, numbers=numbers, worst=worst)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
