"""A plain alist reader for the reference.

The alist text (MacKay's format): a line ``N M``, a line of the largest
column and row weights, a line of the N column weights, a line of the M
row weights, then N lines of each column's 1-based check indices and M
lines of each row's 1-based bit indices, zero-padded to the largest
weight.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np


@dataclass(frozen=True)
class Code:
    """A parity-check code: each check's bits and each bit's checks,
    ascending."""

    n: int
    m: int
    rows: List[np.ndarray]  # rows[j]: the bits of check j
    cols: List[np.ndarray]  # cols[i]: the checks of bit i

    @property
    def edges(self) -> int:
        return int(sum(len(r) for r in self.rows))


def read_alist(path) -> Code:
    lines = Path(path).read_text().splitlines()
    ints = [[int(t) for t in line.split()] for line in lines if line.strip()]
    n, m = ints[0]
    col_w, row_w = ints[2], ints[3]
    if len(col_w) != n or len(row_w) != m:
        raise ValueError(f"{path}: weights do not match N={n}, M={m}")
    cols = [np.array(sorted(v - 1 for v in ints[4 + i] if v), dtype=np.int64)
            for i in range(n)]
    rows = [np.array(sorted(v - 1 for v in ints[4 + n + j] if v),
                     dtype=np.int64) for j in range(m)]
    for i, c in enumerate(cols):
        if len(c) != col_w[i]:
            raise ValueError(f"{path}: column {i} has {len(c)} entries, "
                             f"weight {col_w[i]}")
    for j, r in enumerate(rows):
        if len(r) != row_w[j]:
            raise ValueError(f"{path}: row {j} has {len(r)} entries, "
                             f"weight {row_w[j]}")
    from_rows = {(j, int(i)) for j, r in enumerate(rows) for i in r}
    from_cols = {(int(j), i) for i, c in enumerate(cols) for j in c}
    if from_rows != from_cols:
        raise ValueError(f"{path}: rows and columns list different edges")
    return Code(n, m, rows, cols)
