"""`python -m paddle_tpu_torch.distributed.launch [options] script [args]`
(the launcher runs only as the main module: importing this module starts
nothing)."""
import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
