"""Parity-check matrix representation and the matrix-file dispatcher.

A copy of the parts of ``qkd_ldpc_v_tpu/models/hmatrix.py`` that the
fixed-rate QC path needs: the ``HMatrix`` adjacency-list form (rows kept
sorted ascending), the integer-line reader (pure Python; the JAX package
optionally parses through its native helper, with the same result) and
``read_matrix``. Of the file formats only the QC base-graph format is read
here; the alist, dense and sparse "1"/"2" readers come with the port of the
generic decoder, and ``read_matrix`` raises ``NotImplementedError`` for
them until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from qkd_ldpc_v_tpu_torch.config import MatrixFormat


class MatrixFormatError(ValueError):
    """Raised on malformed matrix files."""


@dataclass
class HMatrix:
    """Sparse parity-check matrix in adjacency-list form (host-side)."""

    # bit_nodes[i]: sorted np.int32 array of check indices for bit column i
    bit_nodes: List[np.ndarray]
    # check_nodes[j]: sorted np.int32 array of bit indices for check row j
    check_nodes: List[np.ndarray]
    is_regular: bool
    source_path: Optional[Path] = None
    # models.qc.QCMatrix when this matrix came from a QC code (kept untyped
    # to avoid a circular import).
    qc: Optional[object] = None

    @property
    def num_bit_nodes(self) -> int:
        return len(self.bit_nodes)

    @property
    def num_check_nodes(self) -> int:
        return len(self.check_nodes)

    @property
    def code_rate(self) -> float:
        """R = 1 - M/N (reference: src/simulation.cpp:389)."""
        return 1.0 - self.num_check_nodes / self.num_bit_nodes


def _sorted_rows(rows: List[List[int]]) -> List[np.ndarray]:
    return [np.array(sorted(r), dtype=np.int32) for r in rows]


def _rows_regular(rows: List[np.ndarray]) -> bool:
    if not rows:
        return True
    first = len(rows[0])
    return all(len(r) == first for r in rows)


def _read_int_lines(path: Path) -> List[List[int]]:
    text = path.read_text()
    if not text.strip():
        raise MatrixFormatError(f"File is empty or cannot be read properly: {path}")
    out = []
    for line in text.splitlines():
        try:
            out.append([int(tok) for tok in line.split()])
        except ValueError as e:
            raise MatrixFormatError(
                f"An error occurred while parsing file: {path}: {e}"
            ) from e
    return out


def _read_qc(matrix_path) -> HMatrix:
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix

    qc = read_qc_matrix(matrix_path)
    matrix = qc.to_hmatrix()
    matrix.source_path = Path(matrix_path)
    return matrix


def read_matrix(matrix_path, matrix_format: MatrixFormat) -> HMatrix:
    """Dispatch on format (reference: src/simulation.cpp:378-385)."""
    if matrix_format != MatrixFormat.QC:
        raise NotImplementedError(
            f"{matrix_format.display_name} matrices are not ported yet: they "
            "come with the generic torch decoder (ROADMAP, port queue)."
        )
    return _read_qc(matrix_path)
