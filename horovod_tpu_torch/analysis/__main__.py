"""``python -m horovod_tpu_torch.analysis`` — the hvdlint CLI (copied from
``horovod_tpu/analysis/__main__.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
