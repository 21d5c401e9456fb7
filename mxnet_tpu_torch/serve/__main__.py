"""``python -m mxnet_tpu_torch.serve`` (see the package's ``_main``)."""
import sys

from . import _main

if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
