"""CLI dispatch: ``mchap {assemble,call,call-pedigree}``.

Reference: mchap/application/cli.py.  The other ``mchap`` tools of
``mchap_tpu`` are not ported yet and exit with an error.
"""

import sys

TOOLS = ["assemble", "call", "call-pedigree"]
NOT_PORTED = ["call-exact", "find-snvs", "atomize"]


def main(command=None):
    if command is None:
        command = sys.argv
    usage = "usage: mchap [-h] {" + ",".join(TOOLS) + "} ..."
    if len(command) < 2 or command[1] in {"-h", "--help"}:
        print(usage)
        print("\nMicro-haplotype assembly and genotype calling (PyTorch/CUDA port)")
        return 0
    tool = command[1]
    if tool == "assemble":
        from mchap_tpu_torch.application.assemble import program
    elif tool == "call":
        from mchap_tpu_torch.application.call import program
    elif tool == "call-pedigree":
        from mchap_tpu_torch.application.call_pedigree import program
    else:
        print(usage, file=sys.stderr)
        if tool in NOT_PORTED:
            print(
                f"error: '{tool}' is not ported yet (see ROADMAP.md);"
                " run it with mchap_tpu",
                file=sys.stderr,
            )
        else:
            print(f"error: unknown tool '{tool}'", file=sys.stderr)
        return 2
    prog = program.cli(command)
    prog.run_stdout()
    return 0


if __name__ == "__main__":
    sys.exit(main())
