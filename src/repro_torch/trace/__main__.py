"""``python -m repro_torch.trace`` — the ``record`` / ``compare`` /
``report`` subcommands of ``python -m repro_torch``, on their own."""

import sys

from repro_torch.trace.cli import main

if __name__ == "__main__":
    sys.exit(main())
