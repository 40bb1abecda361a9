import sys

from ozone_tpu_torch.tools.cli import main

if __name__ == "__main__":
    sys.exit(main())
