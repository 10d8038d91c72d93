"""Degree-grouped edge layout: HMatrix -> static index tables.

A copy of ``qkd_ldpc_v_tpu/models/layout.py``. Nodes are reordered by
degree and split into degree groups:

  * internal bit order  = external bits stably sorted by column weight
  * internal check order = external checks stably sorted by row weight
  * each degree class gets one dense [count, degree] table — exact width,
    no masks, no pad lanes

Edges get two flat enumerations of length E:
  * check-major: group by group, check row by row, slot by slot — so the
    check pass is a reshape of a contiguous slice of the flat message array
  * bit-major: likewise for bit columns — so the bit pass is also reshapes

Regrouping between the two enumerations is one static-index gather per
direction per iteration. The generic torch decoder (``ops/decoders.py``)
works on these tables, and the fused generic kernel
(``csrc/fused_generic.cu``) addresses edges through them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.utils import PlanCache


@dataclass(frozen=True)
class NodeGroup:
    """One degree class of nodes (all rows have exactly `degree` slots).

    ``neighbor``  [count, degree]: internal index of the opposite-side node
                  per slot.
    ``cross_flat`` [count, degree]: position of each slot's edge in the
                  *opposite* enumeration's flat [E] space.
    ``node_start``: first internal node index of this group.
    ``edge_offset``: offset of this group's edges in *this* enumeration's
                  flat [E] space.
    """

    node_start: int
    count: int
    degree: int
    edge_offset: int
    neighbor: np.ndarray
    cross_flat: np.ndarray


@dataclass(frozen=True)
class EdgeLayout:
    """Static tables for one parity-check matrix (host numpy)."""

    num_bits: int  # N
    num_checks: int  # M
    num_edges: int  # E

    # Permutations between external (file) order and internal (degree-sorted)
    # order. x_int = x_ext[..., bit_order]; x_ext = x_int[..., bit_inv].
    bit_order: np.ndarray  # [N] external index at internal position
    bit_inv: np.ndarray  # [N] internal position of external index
    check_order: np.ndarray  # [M]
    check_inv: np.ndarray  # [M]

    check_groups: Tuple[NodeGroup, ...]  # check-major enumeration
    bit_groups: Tuple[NodeGroup, ...]  # bit-major enumeration

    # Fused permutations (concatenations of the groups' cross_flat tables):
    #   x_bit_major = x_check_major[..., to_bit_major]
    #   x_check_major = x_bit_major[..., to_check_major]
    to_bit_major: np.ndarray  # [E]
    to_check_major: np.ndarray  # [E]
    # Internal bit index of each check-major flat position (for syndrome
    # gathers and message init).
    check_edge_bit: np.ndarray  # [E]

    is_regular: bool


def _degree_groups(rows: List[np.ndarray]) -> Tuple[np.ndarray, List[Tuple[int, int, int]]]:
    """Stable-sort node indices by degree; return (order, [(start, count,
    degree)])."""
    degrees = np.array([len(r) for r in rows], dtype=np.int64)
    order = np.argsort(degrees, kind="stable").astype(np.int32)
    sorted_deg = degrees[order]
    groups = []
    start = 0
    while start < len(order):
        d = int(sorted_deg[start])
        end = start
        while end < len(order) and sorted_deg[end] == d:
            end += 1
        groups.append((start, end - start, d))
        start = end
    return order, groups


def compile_layout(matrix: HMatrix) -> EdgeLayout:
    """Compile an HMatrix's Tanner graph into degree-grouped index tables."""
    n = matrix.num_bit_nodes
    m = matrix.num_check_nodes
    check_rows = matrix.check_nodes
    bit_rows = matrix.bit_nodes

    check_order, check_group_spans = _degree_groups(check_rows)
    bit_order, bit_group_spans = _degree_groups(bit_rows)
    check_inv = np.empty(m, dtype=np.int32)
    check_inv[check_order] = np.arange(m, dtype=np.int32)
    bit_inv = np.empty(n, dtype=np.int32)
    bit_inv[bit_order] = np.arange(n, dtype=np.int32)

    check_deg = np.array([len(r) for r in check_rows], dtype=np.int64)
    bit_deg = np.array([len(r) for r in bit_rows], dtype=np.int64)

    # edge_offset of each internal check row in the check-major flat space
    check_row_off = np.zeros(m, dtype=np.int64)
    off = 0
    for pos in range(m):
        check_row_off[pos] = off
        off += check_deg[check_order[pos]]
    num_edges = int(off)

    bit_row_off = np.zeros(n, dtype=np.int64)
    off = 0
    for pos in range(n):
        bit_row_off[pos] = off
        off += bit_deg[bit_order[pos]]
    if int(off) != num_edges:
        raise ValueError("bit and check adjacency count different edges")

    # For edge (check J, bit I): slot within J's ascending row and within I's
    # ascending column.
    # check-major eid = check_row_off[check_inv[J]] + slot_in_row
    # bit-major  eid = bit_row_off[bit_inv[I]] + slot_in_col
    def eid_check_major(J: int, slot: int) -> int:
        return int(check_row_off[check_inv[J]]) + slot

    def eid_bit_major(I: int, slot: int) -> int:
        return int(bit_row_off[bit_inv[I]]) + slot

    check_groups = []
    for start, count, d in check_group_spans:
        neighbor = np.zeros((count, d), dtype=np.int32)
        cross = np.zeros((count, d), dtype=np.int32)
        for local in range(count):
            J = int(check_order[start + local])
            row = check_rows[J]
            for s, I in enumerate(row):
                I = int(I)
                neighbor[local, s] = bit_inv[I]
                col_slot = int(np.searchsorted(bit_rows[I], J))
                cross[local, s] = eid_bit_major(I, col_slot)
        check_groups.append(
            NodeGroup(
                node_start=start,
                count=count,
                degree=d,
                edge_offset=int(check_row_off[start]),
                neighbor=neighbor,
                cross_flat=cross,
            )
        )

    bit_groups = []
    for start, count, d in bit_group_spans:
        neighbor = np.zeros((count, d), dtype=np.int32)
        cross = np.zeros((count, d), dtype=np.int32)
        for local in range(count):
            I = int(bit_order[start + local])
            col = bit_rows[I]
            for s, J in enumerate(col):
                J = int(J)
                neighbor[local, s] = check_inv[J]
                row_slot = int(np.searchsorted(check_rows[J], I))
                cross[local, s] = eid_check_major(J, row_slot)
        bit_groups.append(
            NodeGroup(
                node_start=start,
                count=count,
                degree=d,
                edge_offset=int(bit_row_off[start]),
                neighbor=neighbor,
                cross_flat=cross,
            )
        )

    to_check_major = np.concatenate(
        [g.cross_flat.reshape(-1) for g in check_groups]
    ).astype(np.int32)
    to_bit_major = np.concatenate(
        [g.cross_flat.reshape(-1) for g in bit_groups]
    ).astype(np.int32)
    check_edge_bit = np.concatenate(
        [g.neighbor.reshape(-1) for g in check_groups]
    ).astype(np.int32)

    return EdgeLayout(
        num_bits=n,
        num_checks=m,
        num_edges=num_edges,
        bit_order=bit_order,
        bit_inv=bit_inv,
        check_order=check_order,
        check_inv=check_inv,
        check_groups=tuple(check_groups),
        bit_groups=tuple(bit_groups),
        to_bit_major=to_bit_major,
        to_check_major=to_check_major,
        check_edge_bit=check_edge_bit,
        is_regular=matrix.is_regular,
    )


_LAYOUT_CACHE = PlanCache()


def layout_for(matrix: HMatrix) -> EdgeLayout:
    """Memoized compile_layout keyed by matrix object identity. The cache
    holds the matrix by weakref, so it pins no matrix of a multi-matrix
    campaign."""
    layout = _LAYOUT_CACHE.get(matrix)
    if layout is None:
        layout = compile_layout(matrix)
        _LAYOUT_CACHE.put(matrix, layout)
    return layout
