"""Quasi-cyclic (QC) LDPC codes: generation and block structure.

A copy of ``qkd_ldpc_v_tpu/models/qc.py`` (importing that package imports
JAX). The generators draw from the same NumPy streams in the same order, so
a committed seed gives the identical shift table in both packages.

The reference decodes arbitrary sparse matrices from files; its production
suites are PEG-style random codes (sparse_matrices/*). On TPU the expensive
operation in belief propagation is the edge permutation between check-major
and bit-major message order — an arbitrary gather for random codes. QC-LDPC
codes (the industry-standard structure: 5G NR, 802.11, DVB-S2) replace that
gather with **per-block cyclic rolls**: H is an (mb x nb) grid of Z x Z
circulants, so regrouping messages is a static block permutation (tiny)
plus a static cyclic shift per block — which XLA executes as two contiguous
slices at full HBM bandwidth and a Pallas kernel executes for free as offset
indexing.

Convention: base entry (r, c) with shift s >= 0 contributes edges
check (r*Z + i) <-> bit (c*Z + j) with j = (i + s) mod Z. Entry -1 = no
block. One circulant per base cell (weight-1 circulants only, like 5G NR).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from qkd_ldpc_v_tpu_torch.models.hmatrix import (
    HMatrix,
    MatrixFormatError,
    _read_int_lines,
    _rows_regular,
    _sorted_rows,
)


@dataclass(frozen=True)
class QCMatrix:
    """A lifted QC-LDPC parity-check matrix.

    ``shifts``: [mb, nb] int array, -1 for absent blocks, else the circulant
    shift in [0, Z).
    """

    shifts: np.ndarray
    lifting: int  # Z

    @property
    def base_checks(self) -> int:
        return self.shifts.shape[0]

    @property
    def base_bits(self) -> int:
        return self.shifts.shape[1]

    @property
    def num_check_nodes(self) -> int:
        return self.base_checks * self.lifting

    @property
    def num_bit_nodes(self) -> int:
        return self.base_bits * self.lifting

    @property
    def code_rate(self) -> float:
        return 1.0 - self.num_check_nodes / self.num_bit_nodes

    @property
    def block_edges(self) -> List[Tuple[int, int, int]]:
        """[(base_check r, base_bit c, shift s)] in check-major base order."""
        out = []
        for r in range(self.base_checks):
            for c in range(self.base_bits):
                s = int(self.shifts[r, c])
                if s >= 0:
                    out.append((r, c, s))
        return out

    def to_hmatrix(self) -> HMatrix:
        """Expand to the generic adjacency-list form (host-side components —
        rate adaptation, privacy maintenance, oracle decoding — all operate
        on this; only the device decoder exploits the QC structure)."""
        z = self.lifting
        m = self.num_check_nodes
        n = self.num_bit_nodes
        check_rows: List[List[int]] = [[] for _ in range(m)]
        bit_rows: List[List[int]] = [[] for _ in range(n)]
        for r, c, s in self.block_edges:
            i = np.arange(z)
            j = (i + s) % z
            checks = r * z + i
            bits = c * z + j
            for ch, b in zip(checks, bits):
                check_rows[ch].append(int(b))
                bit_rows[b].append(int(ch))
        check_nodes = _sorted_rows(check_rows)
        bit_nodes = _sorted_rows(bit_rows)
        return HMatrix(
            bit_nodes=bit_nodes,
            check_nodes=check_nodes,
            is_regular=_rows_regular(check_nodes) and _rows_regular(bit_nodes),
            qc=self,
        )


def generate_qc_ldpc(
    base_bits: int,
    base_checks: int,
    lifting: int,
    column_weight: int = 3,
    seed: int = 0,
) -> QCMatrix:
    """Regular QC-LDPC construction with girth-aware shift assignment.

    Base graph: every base column gets exactly ``column_weight`` blocks at
    distinct base rows, spread to keep base row weights balanced. Shifts are
    then assigned greedily cell by cell: the Fossorier condition says a base
    cycle r1-c1-r2-c2-...-rk-ck lifts to short cycles iff its alternating
    shift sum is 0 mod Z, so for each cell we enumerate all base 4-cycle and
    6-cycle closures through already-assigned cells, convert each into the
    *residue* the new shift must avoid, and score every candidate shift at
    once: 4-cycle residues are forbidden, 6-cycle residues are penalties
    (weighted by multiplicity). The result is 4-cycle-free and approximately
    6-cycle-minimal — girth >= 8 whenever a zero-penalty assignment exists.
    """
    if column_weight > base_checks:
        raise ValueError(
            f"column_weight {column_weight} needs at least that many base "
            f"rows (base_checks={base_checks})"
        )
    rng = np.random.default_rng(seed)
    z = lifting
    shifts = np.full((base_checks, base_bits), -1, dtype=np.int64)
    row_load = np.zeros(base_checks, dtype=np.int64)

    for c in range(base_bits):
        # Least-loaded base rows first, random tie-break.
        order = rng.permutation(base_checks)
        sel = order[np.argsort(row_load[order], kind="stable")][:column_weight]
        for r in sel:
            row_load[r] += 1
            shifts[r, c] = 0  # placeholder: cell exists, shift unassigned

    cells = [(r, c) for r in range(base_checks) for c in range(base_bits)
             if shifts[r, c] >= 0]
    assigned = np.zeros_like(shifts, dtype=bool)
    row_cols = [np.flatnonzero(shifts[r] >= 0) for r in range(base_checks)]
    col_rows = [np.flatnonzero(shifts[:, c] >= 0) for c in range(base_bits)]

    for idx in rng.permutation(len(cells)):
        r, c = cells[idx]
        forbidden: List[int] = []
        penalties: List[int] = []

        # 4-cycles: r-c .. r-c2 .. r2-c2 .. r2-c. The new shift s closes a
        # lifted 4-cycle iff s == s(r2,c) - s(r2,c2) + s(r,c2) (mod Z).
        for c2 in row_cols[r]:
            if c2 == c or not assigned[r, c2]:
                continue
            for r2 in col_rows[c2]:
                # assigned[r2, c] implies the (r2, c) cell exists.
                if r2 == r or not assigned[r2, c2] or not assigned[r2, c]:
                    continue
                forbidden.append(
                    int((shifts[r2, c] - shifts[r2, c2] + shifts[r, c2]) % z)
                )

        # 6-cycles: r-c .. r-c2 .. r2-c2 .. r2-c3 .. r3-c3 .. r3-c.
        # s == s(r,c2) - s(r2,c2) + s(r2,c3) - s(r3,c3) + s(r3,c) (mod Z).
        for c2 in row_cols[r]:
            if c2 == c or not assigned[r, c2]:
                continue
            for r2 in col_rows[c2]:
                if r2 == r or not assigned[r2, c2]:
                    continue
                for c3 in row_cols[r2]:
                    if c3 in (c, c2) or not assigned[r2, c3]:
                        continue
                    for r3 in col_rows[c3]:
                        if r3 in (r, r2) or not assigned[r3, c3]:
                            continue
                        if not assigned[r3, c]:  # implies the cell exists
                            continue
                        penalties.append(
                            int(
                                (
                                    shifts[r, c2] - shifts[r2, c2]
                                    + shifts[r2, c3] - shifts[r3, c3]
                                    + shifts[r3, c]
                                ) % z
                            )
                        )

        score = np.zeros(z, dtype=np.int64)
        if penalties:
            np.add.at(score, np.asarray(penalties), 1)
        forbidden_sentinel = np.iinfo(np.int64).max // 2
        if forbidden:
            score[np.asarray(forbidden)] = forbidden_sentinel
        best = score.min()
        if best >= forbidden_sentinel:
            # Every residue closes a lifted 4-cycle (only possible when Z is
            # small relative to the base-graph density); the guarantee in
            # the docstring cannot hold for these parameters.
            import logging

            logging.getLogger("qkd_ldpc_v_tpu_torch").warning(
                "QC shift assignment at base cell (%d, %d): all %d shifts "
                "close a lifted 4-cycle; increase the lifting size.",
                r, c, z,
            )
        candidates = np.flatnonzero(score == best)
        shifts[r, c] = int(candidates[rng.integers(len(candidates))])
        assigned[r, c] = True

    return QCMatrix(shifts=shifts, lifting=z)


def generate_qc_peg(
    base_bits: int,
    base_checks: int,
    lifting: int,
    column_weight: int = 3,
    seed: int = 0,
) -> QCMatrix:
    """QC-PEG: progressive edge growth on the *lifted* graph.

    Classic PEG (Hu/Eleftheriou/Arnold) attaches each new edge to the check
    node farthest from the bit in the current graph, maximizing local girth.
    For a QC lift this specializes cleanly: by circulant symmetry, distances
    from bit (c, 0) replicate to every (c, j), so one BFS per edge decides
    the whole circulant. Choosing the attachment check (r, z0) for bit
    (c, 0) fixes the block shift s = (-z0) mod Z.

    Selection rule per edge: unreachable checks first (keeps the graph
    spread), else maximal BFS distance; ties broken by minimal current
    check-node degree, then uniformly at random.
    """
    if column_weight > base_checks:
        raise ValueError(
            f"column_weight {column_weight} needs at least that many base "
            f"rows (base_checks={base_checks})"
        )
    rng = np.random.default_rng(seed)
    z = lifting
    m = base_checks * z
    shifts = np.full((base_checks, base_bits), -1, dtype=np.int64)

    # Lifted adjacency (built incrementally): for BFS we need, per bit and
    # per check, the incident opposite-side nodes.
    bit_adj: List[List[int]] = [[] for _ in range(base_bits * z)]
    check_adj: List[List[int]] = [[] for _ in range(m)]
    check_deg = np.zeros(m, dtype=np.int64)

    INF = np.iinfo(np.int64).max

    def bfs_check_distances(c: int) -> np.ndarray:
        """Distance from bit (c, 0) to every lifted check (edges = 1 hop
        bit->check)."""
        dist = np.full(m, INF, dtype=np.int64)
        start = c * z
        frontier_bits = [start]
        seen_bits = {start}
        depth = 0
        while frontier_bits:
            next_checks = []
            for b in frontier_bits:
                for ch in bit_adj[b]:
                    if dist[ch] == INF:
                        dist[ch] = depth + 1
                        next_checks.append(ch)
            frontier_bits = []
            for ch in next_checks:
                for b in check_adj[ch]:
                    if b not in seen_bits:
                        seen_bits.add(b)
                        frontier_bits.append(b)
            depth += 2
        return dist

    def attach(r: int, c: int, s: int) -> None:
        shifts[r, c] = s
        i = np.arange(z)
        j = (i + s) % z
        for zi, zj in zip(i, j):
            ch = r * z + int(zi)
            b = c * z + int(zj)
            check_adj[ch].append(b)
            bit_adj[b].append(ch)
        check_deg[r * z:(r + 1) * z] += 1

    for c in range(base_bits):
        used_rows: List[int] = []
        for _ in range(column_weight):
            dist = bfs_check_distances(c)
            # Mask checks in already-used base rows.
            for r in used_rows:
                dist[r * z:(r + 1) * z] = -1
            reachable_max = dist[(dist >= 0) & (dist < INF)]
            if (dist == INF).any():
                cand = np.flatnonzero(dist == INF)
            else:
                cand = np.flatnonzero(dist == reachable_max.max())
            min_deg = check_deg[cand].min()
            cand = cand[check_deg[cand] == min_deg]
            chosen = int(cand[rng.integers(len(cand))])
            r, z0 = divmod(chosen, z)
            attach(r, c, (-z0) % z)
            used_rows.append(r)

    return QCMatrix(shifts=shifts, lifting=z)


def write_qc_matrix(qc: QCMatrix, path) -> None:
    """Write the base-graph shift table: header "mb nb Z", then mb rows of
    nb shifts (-1 = absent block). The reference has no QC format; these
    files live under sparse_matrices/matrices_qc/."""
    from pathlib import Path

    lines = [f"{qc.base_checks} {qc.base_bits} {qc.lifting}"]
    for r in range(qc.base_checks):
        lines.append(" ".join(str(int(s)) for s in qc.shifts[r]))
    Path(path).write_text("\n".join(lines) + "\n")


def read_qc_matrix(path) -> QCMatrix:
    """Read a .mtrx file in the QC base-graph format (see write_qc_matrix)."""
    from pathlib import Path

    path = Path(path)
    lines = [ln for ln in _read_int_lines(path) if ln]
    if not lines:
        raise MatrixFormatError(f"File is empty or cannot be read properly: {path}")
    header = lines[0]
    if len(header) != 3:
        raise MatrixFormatError(f"Wrong QC matrix header (want 'mb nb Z'): {path}")
    mb, nb, z = header
    if mb <= 0 or nb <= 0 or z <= 0:
        raise MatrixFormatError(
            f"QC header values must be positive (got mb={mb} nb={nb} Z={z}). "
            f"File: {path}"
        )
    if len(lines) < 1 + mb:
        raise MatrixFormatError(f"Insufficient data in the file: {path}")
    shifts = np.full((mb, nb), -1, dtype=np.int64)
    for r in range(mb):
        row = lines[1 + r]
        if len(row) != nb:
            raise MatrixFormatError(
                f"Row {r} has {len(row)} entries, expected {nb}. File: {path}"
            )
        for c, s in enumerate(row):
            if s >= z or s < -1:
                raise MatrixFormatError(
                    f"Shift {s} out of range (-1 or [0,{z})) at ({r},{c}). "
                    f"File: {path}"
                )
            shifts[r, c] = s
    return QCMatrix(shifts=shifts, lifting=z)
