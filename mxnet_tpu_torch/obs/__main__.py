"""``python -m mxnet_tpu_torch.obs --check [--device cpu]``: the
mini-fleet observability gate."""
import sys

from .check import _main

if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
