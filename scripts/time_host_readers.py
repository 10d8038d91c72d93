"""Time the host readers of both packages on one matrix, on the CPU.

The JAX package parses matrix files and runs the untainted greedy in its
native helper (qkd_ldpc_v_tpu/native.py over native/qkdldpc_native.cpp);
the port runs both in Python (qkd_ldpc_v_tpu_torch/models/hmatrix.py's
``_read_int_lines``, rate_adapt.py's ``_untainted_greedy_py``). This script
times each side on the same file and second-order neighbourhoods and checks
that both give the same integers and the same positions.

Usage: python scripts/time_host_readers.py [--matrix ALIST] [--seed 2067]

It needs the JAX package and its native helper (``make -C native``), so it
runs where those are installed, not on the card machine. There,
chip_smoke.py phase 6c times the port's side alone with
``port_host_times``, which imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ALIST_100K = (ROOT / "sparse_matrices" / "matrices_alist"
              / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def port_host_times(path: Path = ALIST_100K, seed: int = 2067):
    """The port's whole read of the alist matrix at ``path`` and its whole
    untainted greedy from ``default_rng(seed)`` (second-order neighbourhoods
    included): (read seconds, greedy seconds, positions)."""
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.rate_adapt import select_punctured_bits_untainted

    matrix, read_s = timed(read_sparse_matrix_alist, path)
    pos, greedy_s = timed(select_punctured_bits_untainted,
                          np.random.default_rng(seed), matrix)
    return read_s, greedy_s, pos


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--matrix", type=Path, default=ALIST_100K)
    p.add_argument("--seed", type=int, default=2067,
                   help="numpy seed of the greedy's draw (make_assets.py's)")
    args = p.parse_args(argv)

    from qkd_ldpc_v_tpu import native
    from qkd_ldpc_v_tpu_torch import rate_adapt as tra
    from qkd_ldpc_v_tpu_torch.models import hmatrix as thm

    if native.load() is None:
        raise RuntimeError("the native helper is not built (make -C native)")
    print(f"CPU: {platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} logical cores; matrix {args.matrix.name}")

    rows, py_s = timed(thm._read_int_lines, args.matrix)
    parsed, nat_s = timed(lambda: native.parse_int_lines(args.matrix.read_text()))
    if parsed != rows:
        raise RuntimeError("the native parser and the Python loop differ")
    print(f"tokenize: native {nat_s:.3f} s, port's Python loop {py_s:.3f} s "
          f"({sum(map(len, rows))} integers)")

    matrix = thm.read_sparse_matrix_alist(args.matrix)
    (flat, offsets), csr_s = timed(tra.second_order_csr, matrix)
    seed = int(np.random.default_rng(args.seed).integers(0, 1 << 63))
    py_pos, py_s = timed(tra._untainted_greedy_py, flat, offsets, seed)
    nat_pos, nat_s = timed(native.untainted_select, flat, offsets, seed)
    if not np.array_equal(py_pos, nat_pos):
        raise RuntimeError("the native greedy and the Python greedy differ")
    print(f"untainted greedy: native {nat_s:.3f} s, port's Python greedy "
          f"{py_s:.3f} s ({len(py_pos)} positions, equal); second_order_csr "
          f"{csr_s:.3f} s (both packages run it in Python)")
    read_s, greedy_s, pos = port_host_times(args.matrix, args.seed)
    if not np.array_equal(pos, py_pos):
        raise RuntimeError("port_host_times differs from the Python greedy")
    print(f"the port's whole read {read_s:.3f} s and whole greedy "
          f"{greedy_s:.3f} s (port_host_times, as chip_smoke.py phase 6c)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
