"""``python -m style_transfer_tpu_torch`` entry point."""

import sys

from style_transfer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
