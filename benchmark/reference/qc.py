"""A plain reader of quasi-cyclic (QC) parity-check matrices for the
reference.

The QC text: a line ``mb nb Z``, then ``mb`` lines of ``nb`` shifts, ``-1``
for a zero block and ``0 .. Z - 1`` for a Z x Z circulant. Block edge
``(r, c, s)`` joins check ``r*Z + z`` to bit ``c*Z + (z + s) mod Z`` for
every ``z`` in ``0 .. Z - 1``. Block edges are numbered in storage order:
row by row, each row's blocks left to right.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

from benchmark.reference.alist import Code


@dataclass(frozen=True)
class QC:
    """A QC code: its base matrix of shifts [mb, nb] and the lifting Z."""

    shifts: np.ndarray
    z: int

    @property
    def n(self) -> int:
        return self.shifts.shape[1] * self.z

    @property
    def m(self) -> int:
        return self.shifts.shape[0] * self.z

    def block_edges(self, r: int) -> List[Tuple[int, int]]:
        """(c, s) of block-row ``r``'s blocks, in storage order."""
        return [(c, int(s)) for c, s in enumerate(self.shifts[r]) if s >= 0]


def read_qc(path) -> QC:
    lines = [line.split() for line in Path(path).read_text().splitlines()
             if line.strip()]
    mb, nb, z = (int(t) for t in lines[0])
    if mb <= 0 or nb <= 0 or z <= 0 or len(lines) < 1 + mb:
        raise ValueError(f"{path}: not a QC matrix (header {lines[0]})")
    shifts = np.array([[int(t) for t in line] for line in lines[1:1 + mb]],
                      dtype=np.int64)
    if shifts.shape != (mb, nb):
        raise ValueError(f"{path}: a row does not have {nb} shifts")
    if ((shifts < -1) | (shifts >= z)).any():
        raise ValueError(f"{path}: a shift lies outside -1 .. {z - 1}")
    return QC(shifts, z)


def block_row_bits(qc: QC, r: int) -> np.ndarray:
    """[Z, d] int64: the bits of block-row ``r``'s checks, check ``r*Z + z``
    in row ``z``, one column a block edge in storage order. Each bit
    appears at most once in a block-row."""
    z = np.arange(qc.z)
    return np.stack([c * qc.z + (z + s) % qc.z for c, s in qc.block_edges(r)],
                    axis=1)


def expand(qc: QC) -> Code:
    """The code as check and bit lists, each ascending."""
    rows: List[np.ndarray] = []
    cols: List[List[int]] = [[] for _ in range(qc.n)]
    for r in range(qc.shifts.shape[0]):
        for z, bits in enumerate(block_row_bits(qc, r)):
            rows.append(np.sort(bits))
            for b in bits:
                cols[int(b)].append(r * qc.z + z)
    return Code(qc.n, qc.m, rows,
                [np.array(sorted(c), dtype=np.int64) for c in cols])
