"""Entry point: ``python -m mchap_tpu_torch <tool> ...``."""

import sys

from mchap_tpu_torch.application.cli import main

if __name__ == "__main__":
    sys.exit(main(["mchap"] + sys.argv[1:]))
