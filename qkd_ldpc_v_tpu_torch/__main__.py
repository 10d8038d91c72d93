"""``python -m qkd_ldpc_v_tpu_torch`` entry point."""

import sys

from qkd_ldpc_v_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
