"""``python -m repro_torch.sweep`` — the same as ``python -m repro_torch
sweep`` (run / report)."""

import sys

from repro_torch.sweep.cli import main

if __name__ == "__main__":
    sys.exit(main())
