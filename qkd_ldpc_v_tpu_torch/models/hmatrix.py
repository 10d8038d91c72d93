"""Parity-check matrix representation, file readers and writers.

A copy of ``qkd_ldpc_v_tpu/models/hmatrix.py`` (importing that package
imports JAX). The in-memory form is an adjacency list like the reference's
``H_matrix`` (reference: src/array_and_matrix_operations.hpp:60-77):
``bit_nodes[i]`` are the check indices incident on bit column i,
``check_nodes[j]`` the bit indices on check row j, both kept sorted
ascending, plus a regularity flag.

All four reference file formats are read with the same validation rules,
plus the QC base-graph format:
  * uncompressed dense 0/1 text        (src/array_and_matrix_operations.cpp:764-886)
  * alist                              (src/array_and_matrix_operations.cpp:291-468)
  * format 1 (MacKay/PEG)              (src/array_and_matrix_operations.cpp:478-617)
  * format 2 (rows then columns)       (src/array_and_matrix_operations.cpp:626-761)

The integer-line reader is pure Python; the JAX package optionally parses
through its native helper, with the same result.
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
    # Max-size untainted puncturable positions (filled lazily; see rate_adapt)
    punctured_bits_untainted: Optional[np.ndarray] = None
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
    def num_edges(self) -> int:
        return sum(len(row) for row in self.check_nodes)

    @property
    def code_rate(self) -> float:
        """R = 1 - M/N (reference: src/simulation.cpp:389)."""
        return 1.0 - self.num_check_nodes / self.num_bit_nodes

    def to_dense(self) -> np.ndarray:
        """Dense 0/1 matrix [M, N] (for tests / tiny matrices only)."""
        dense = np.zeros((self.num_check_nodes, self.num_bit_nodes), dtype=np.int8)
        for j, bits in enumerate(self.check_nodes):
            dense[j, bits] = 1
        return dense

    def validate_consistency(self) -> None:
        """Check that bit_nodes and check_nodes describe the same edge set."""
        edges_from_checks = {
            (j, int(b)) for j, bits in enumerate(self.check_nodes) for b in bits
        }
        edges_from_bits = {
            (int(c), i) for i, checks in enumerate(self.bit_nodes) for c in checks
        }
        if edges_from_checks != edges_from_bits:
            raise MatrixFormatError(
                "bit_nodes and check_nodes describe different edge sets"
            )


def _sorted_rows(rows: List[List[int]]) -> List[np.ndarray]:
    return [np.array(sorted(r), dtype=np.int32) for r in rows]


def _rows_regular(rows: List[np.ndarray]) -> bool:
    if not rows:
        return True
    first = len(rows[0])
    return all(len(r) == first for r in rows)


def from_dense(dense: np.ndarray, source_path: Optional[Path] = None) -> HMatrix:
    """Build an HMatrix from a dense 0/1 array [M, N]."""
    dense = np.asarray(dense)
    check_nodes = [np.flatnonzero(row).astype(np.int32) for row in dense]
    bit_nodes = [np.flatnonzero(col).astype(np.int32) for col in dense.T]
    is_regular = _rows_regular(check_nodes) and _rows_regular(bit_nodes)
    return HMatrix(bit_nodes, check_nodes, is_regular, source_path=source_path)


def bit_nodes_from_check_nodes(
    check_nodes: List[np.ndarray], num_bits: Optional[int] = None
) -> List[np.ndarray]:
    """Transpose adjacency (reference: src/array_and_matrix_operations.cpp:55-84)."""
    if num_bits is None:
        num_bits = 1 + max(int(r.max()) for r in check_nodes if len(r))
    buckets: List[List[int]] = [[] for _ in range(num_bits)]
    for j, bits in enumerate(check_nodes):
        for b in bits:
            buckets[int(b)].append(j)
    return [np.array(b, dtype=np.int32) for b in buckets]


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


def read_sparse_uncompressed_matrix(matrix_path) -> HMatrix:
    """Dense 0/1 text (reference: src/array_and_matrix_operations.cpp:764-886)."""
    path = Path(matrix_path)
    rows = _read_int_lines(path)
    rows = [r for r in rows if r]  # tolerate trailing blank lines
    if not rows:
        raise MatrixFormatError(f"File is empty or cannot be read properly: {path}")
    for r in rows:
        for v in r:
            if v not in (0, 1):
                raise MatrixFormatError(
                    "Parity check matrix can only take values 0 or 1."
                )
    width = len(rows[0])
    for r in rows:
        if len(r) != width:
            raise MatrixFormatError(
                f"Different lengths of rows in a matrix. File: {path}"
            )
    dense = np.array(rows, dtype=np.int8)
    col_w = dense.sum(axis=0)
    row_w = dense.sum(axis=1)
    if (col_w == 0).any():
        i = int(np.flatnonzero(col_w == 0)[0])
        raise MatrixFormatError(
            f"Column '{i + 1}' weight cannot be equal to zero. File: {path}"
        )
    if (row_w == 0).any():
        i = int(np.flatnonzero(row_w == 0)[0])
        raise MatrixFormatError(
            f"Row '{i + 1}' weight cannot be equal to zero. File: {path}"
        )
    return from_dense(dense, source_path=path)


def read_sparse_matrix_alist(matrix_path) -> HMatrix:
    """alist format (reference: src/array_and_matrix_operations.cpp:291-468)."""
    path = Path(matrix_path)
    vec = _read_int_lines(path)
    if len(vec) < 4:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    if len(vec[0]) != 2 or len(vec[1]) != 2:
        raise MatrixFormatError(f"Wrong sparse alist matrix format: {path}")
    col_num, row_num = vec[0]
    num_bit_nodes = len(vec[2])
    num_check_nodes = len(vec[3])
    if len(vec) < 4 + num_bit_nodes + num_check_nodes:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    if col_num != num_bit_nodes:
        raise MatrixFormatError(
            f"Number of columns '{col_num}' is not the same as the length of "
            f"the third line '{num_bit_nodes}'. File: {path}"
        )
    if row_num != num_check_nodes:
        raise MatrixFormatError(
            f"Number of rows '{row_num}' is not the same as the length of "
            f"the fourth line '{num_check_nodes}'. File: {path}"
        )
    bit_weights = vec[2]
    check_weights = vec[3]
    is_regular = all(w == bit_weights[0] for w in bit_weights) and all(
        w == check_weights[0] for w in check_weights
    )
    # Zero-padded rows: the number of non-zero entries must equal the declared
    # weight (reference validation at :392-423).
    cur = 4
    for i in range(num_bit_nodes):
        non_zero = sum(1 for v in vec[cur + i] if v != 0)
        if non_zero != bit_weights[i]:
            raise MatrixFormatError(
                f"Number of non-zero elements '{non_zero}' in the line "
                f"'{cur + i + 1}' does not match the weight in the third line "
                f"'{bit_weights[i]}'. File: {path}"
            )
    cur = 4 + num_bit_nodes
    for i in range(num_check_nodes):
        non_zero = sum(1 for v in vec[cur + i] if v != 0)
        if non_zero != check_weights[i]:
            raise MatrixFormatError(
                f"Number of non-zero elements '{non_zero}' in the line "
                f"'{cur + i + 1}' does not match the weight in the fourth line "
                f"'{check_weights[i]}'. File: {path}"
            )
    cur = 4
    bit_nodes = [
        [v - 1 for v in vec[cur + i][: bit_weights[i]]] for i in range(num_bit_nodes)
    ]
    cur = 4 + num_bit_nodes
    check_nodes = [
        [v - 1 for v in vec[cur + i][: check_weights[i]]]
        for i in range(num_check_nodes)
    ]
    return HMatrix(
        _sorted_rows(bit_nodes), _sorted_rows(check_nodes), is_regular,
        source_path=path,
    )


def read_sparse_matrix_1(matrix_path) -> HMatrix:
    """MacKay/PEG format 1 (reference: src/array_and_matrix_operations.cpp:478-617).

    Header: N, M, max-row-weight on three lines; then M rows of 1-based bit
    indices, 0 = padding.
    """
    path = Path(matrix_path)
    vec = _read_int_lines(path)
    if len(vec) < 3:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    if len(vec[0]) != 1 or len(vec[1]) != 1 or len(vec[2]) != 1:
        raise MatrixFormatError(f"Wrong sparse matrix format: {path}")
    col_num = vec[0][0]
    row_num = vec[1][0]
    max_row_weight = vec[2][0]
    if len(vec) < 3 + row_num:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    max_weights_matched = False
    check_nodes: List[List[int]] = []
    for i in range(row_num):
        row = vec[3 + i]
        if len(row) > max_row_weight:
            raise MatrixFormatError(
                f"Actual weight '{len(row)}' of row '{3 + i}' exceeded the "
                f"maximum specified weight '{max_row_weight}'."
            )
        if len(row) == max_row_weight:
            max_weights_matched = True
        entries = []
        for v in row:
            if v < 0:
                raise MatrixFormatError(
                    f"Bit node index cannot be less than zero: {v}, row "
                    f"'{3 + i}'."
                )
            if v != 0:
                entries.append(v - 1)
        check_nodes.append(entries)
    if not max_weights_matched:
        raise MatrixFormatError(
            f"None of the row weights matched the specified maximum weight "
            f"'{max_row_weight}'. File: {path}"
        )
    check_rows = _sorted_rows(check_nodes)
    is_regular = _rows_regular(check_rows)
    bit_nodes = bit_nodes_from_check_nodes(check_rows)
    if len(bit_nodes) != col_num:
        raise MatrixFormatError(
            f"The actual number of bit nodes '{len(bit_nodes)}' did not match "
            f"the specified number '{col_num}' of bit nodes."
        )
    return HMatrix(bit_nodes, check_rows, is_regular, source_path=path)


def read_sparse_matrix_2(matrix_path) -> HMatrix:
    """Format 2 (reference: src/array_and_matrix_operations.cpp:626-761).

    Header "N M"; then M rows of 0-based bit indices; then N rows of 0-based
    check indices.
    """
    path = Path(matrix_path)
    vec = _read_int_lines(path)
    if len(vec) < 2:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    if len(vec[0]) != 2:
        raise MatrixFormatError(f"Wrong sparse matrix format: {path}")
    col_num, row_num = vec[0]
    if len(vec) < 1 + col_num + row_num:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    check_nodes: List[List[int]] = []
    for i in range(row_num):
        for v in vec[1 + i]:
            if v < 0:
                raise MatrixFormatError(
                    f"Bit node index cannot be less than zero: {v}, row "
                    f"'{1 + i}'."
                )
        check_nodes.append(list(vec[1 + i]))
    bit_nodes: List[List[int]] = []
    for i in range(col_num):
        for v in vec[1 + row_num + i]:
            if v < 0:
                raise MatrixFormatError(
                    f"Check node index cannot be less than zero: {v}, row "
                    f"'{1 + row_num + i}'."
                )
        bit_nodes.append(list(vec[1 + row_num + i]))
    check_rows = _sorted_rows(check_nodes)
    bit_rows = _sorted_rows(bit_nodes)
    is_regular = _rows_regular(check_rows) and _rows_regular(bit_rows)
    return HMatrix(bit_rows, check_rows, is_regular, source_path=path)


def _read_qc(matrix_path) -> HMatrix:
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix

    qc = read_qc_matrix(matrix_path)
    matrix = qc.to_hmatrix()
    matrix.source_path = Path(matrix_path)
    return matrix


_READERS = {
    MatrixFormat.UNCOMPRESSED: read_sparse_uncompressed_matrix,
    MatrixFormat.ALIST: read_sparse_matrix_alist,
    MatrixFormat.SPARSE_1: read_sparse_matrix_1,
    MatrixFormat.SPARSE_2: read_sparse_matrix_2,
    MatrixFormat.QC: _read_qc,
}


def read_matrix(matrix_path, matrix_format: MatrixFormat) -> HMatrix:
    """Dispatch on format (reference: src/simulation.cpp:378-385; QC is the
    JAX package's extension format)."""
    return _READERS[matrix_format](matrix_path)


def write_dense(matrix: HMatrix, path) -> None:
    """Write an HMatrix as dense 0/1 text (the reference's uncompressed
    format, read by read_sparse_uncompressed_matrix)."""
    path = Path(path)
    n = matrix.num_bit_nodes
    lines = []
    for row in matrix.check_nodes:
        vals = ["0"] * n
        for v in row:
            vals[int(v)] = "1"
        lines.append(" ".join(vals))
    path.write_text("\n".join(lines) + "\n")


def write_sparse_1(matrix: HMatrix, path) -> None:
    """Write an HMatrix in format 1 (read by read_sparse_matrix_1): N, M,
    max-row-weight header lines, then M rows of 1-based bit indices
    zero-padded to the maximum row weight."""
    path = Path(path)
    max_w = max(len(r) for r in matrix.check_nodes)
    lines = [
        str(matrix.num_bit_nodes),
        str(matrix.num_check_nodes),
        str(max_w),
    ]
    for row in matrix.check_nodes:
        entries = [str(int(v) + 1) for v in row] + ["0"] * (max_w - len(row))
        lines.append(" ".join(entries))
    path.write_text("\n".join(lines) + "\n")


def write_sparse_2(matrix: HMatrix, path) -> None:
    """Write an HMatrix in format 2 (read by read_sparse_matrix_2): "N M"
    header, M rows of 0-based bit indices, then N rows of 0-based check
    indices."""
    path = Path(path)
    lines = [f"{matrix.num_bit_nodes} {matrix.num_check_nodes}"]
    for row in matrix.check_nodes:
        lines.append(" ".join(str(int(v)) for v in row))
    for row in matrix.bit_nodes:
        lines.append(" ".join(str(int(v)) for v in row))
    path.write_text("\n".join(lines) + "\n")


def write_alist(matrix: HMatrix, path) -> None:
    """Write an HMatrix in alist format (read by read_sparse_matrix_alist)."""
    path = Path(path)
    n = matrix.num_bit_nodes
    m = matrix.num_check_nodes
    bit_w = [len(r) for r in matrix.bit_nodes]
    check_w = [len(r) for r in matrix.check_nodes]
    max_bw = max(bit_w)
    max_cw = max(check_w)
    lines = [
        f"{n} {m}",
        f"{max_bw} {max_cw}",
        " ".join(str(w) for w in bit_w),
        " ".join(str(w) for w in check_w),
    ]
    for row, w in ((matrix.bit_nodes, max_bw), (matrix.check_nodes, max_cw)):
        for r in row:
            entries = [str(int(v) + 1) for v in r] + ["0"] * (w - len(r))
            lines.append(" ".join(entries))
    path.write_text("\n".join(lines) + "\n")
