"""CLI dispatch: ``mchap {assemble,call,call-exact,call-pedigree,find-snvs,atomize}``.

Reference: mchap/application/cli.py.
"""

import sys

TOOLS = ["assemble", "call", "call-exact", "call-pedigree", "find-snvs", "atomize"]


def main(command=None):
    if command is None:
        command = sys.argv
    usage = "usage: mchap [-h] {" + ",".join(TOOLS) + "} ..."
    if len(command) < 2 or command[1] in {"-h", "--help"}:
        print(usage)
        print("\nMicro-haplotype assembly and genotype calling (PyTorch/CUDA port)")
        return 0
    tool = command[1]
    if tool == "find-snvs":
        from mchap_tpu_torch.application.find_snvs import main as find_snvs_main

        find_snvs_main(command)
        return 0
    if tool == "atomize":
        from mchap_tpu_torch.application.atomize import main as atomize_main

        atomize_main(command)
        return 0
    if tool == "assemble":
        from mchap_tpu_torch.application.assemble import program
    elif tool == "call":
        from mchap_tpu_torch.application.call import program
    elif tool == "call-exact":
        from mchap_tpu_torch.application.call_exact import program
    elif tool == "call-pedigree":
        from mchap_tpu_torch.application.call_pedigree import program
    else:
        print(usage, file=sys.stderr)
        print(f"error: unknown tool '{tool}'", file=sys.stderr)
        return 2
    prog = program.cli(command)
    prog.run_stdout()
    return 0


if __name__ == "__main__":
    sys.exit(main())
