"""``python -m horovod_tpu_torch.serve`` — the hvdserve CLI of the port."""

import sys

from .server import run_commandline

if __name__ == "__main__":
    sys.exit(run_commandline())
