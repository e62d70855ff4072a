import sys

from repro_torch.net.cli import main

if __name__ == "__main__":
    sys.exit(main())
