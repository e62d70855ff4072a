"""``python -m repro_torch.tune`` — the same CLI as
``python -m repro_torch tune``."""

import sys

from repro_torch.tune.cli import main

if __name__ == "__main__":
    sys.exit(main(prog="python -m repro_torch.tune"))
