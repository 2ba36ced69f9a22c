"""``python -m cometbft_tpu_torch``: the command line (``cmd/``)."""

import sys

from .cmd import main

if __name__ == "__main__":
    sys.exit(main())
