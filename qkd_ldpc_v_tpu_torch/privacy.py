"""Privacy maintenance: greedy selection of key bits to delete.

A copy of ``qkd_ldpc_v_tpu/privacy.py`` (importing that package imports
JAX). Host-side combinatorics (NumPy/Python) producing static index vectors
(reference: src/array_and_matrix_operations.cpp:121-287):

  * each removed bit "uses up" one distinct check node: bits are visited in
    ascending column weight and greedily matched to the first unused check
    in their adjacency list;
  * the rate-adaptation variant first deletes all shortened and punctured
    bits (marking a check per punctured bit), then fills up from the
    remaining bits.

Like the JAX package, candidate bits of equal column weight keep ascending
bit order (a stable sort); the reference's ``std::sort`` leaves that order
unspecified.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix


def _first_available(candidates: Iterable[int], used: set) -> int:
    """First element of `candidates` not in `used`, else -1
    (reference: src/array_and_matrix_operations.cpp:121-136)."""
    for c in candidates:
        if int(c) not in used:
            return int(c)
    return -1


def bits_positions_to_remove(matrix: HMatrix) -> np.ndarray:
    """Positions to delete for privacy maintenance, fixed-rate case
    (reference: src/array_and_matrix_operations.cpp:140-185)."""
    weights = np.array([len(r) for r in matrix.bit_nodes])
    order = np.argsort(weights, kind="stable")
    used: set = set()
    remove = []
    for i in order:
        idx = _first_available(matrix.bit_nodes[int(i)], used)
        if idx != -1:
            remove.append(int(i))
            used.add(idx)
    remove.sort()
    return np.array(remove, dtype=np.int32)


def bits_positions_to_remove_rate_adapt(
    matrix: HMatrix,
    punctured_bits: np.ndarray,
    shortened_bits: np.ndarray,
) -> np.ndarray:
    """Rate-adaptive variant: all shortened+punctured bits are deleted first
    (punctured bits mark one adjacent check each), then the remaining bits
    fill up greedily (reference: src/array_and_matrix_operations.cpp:189-256)."""
    n = matrix.num_bit_nodes
    punct = set(int(p) for p in punctured_bits)
    short = set(int(s) for s in shortened_bits)
    used: set = set()
    remove = []
    candidates = []
    for i in range(n):
        if i in short:
            remove.append(i)
        elif i in punct:
            remove.append(i)
            idx = _first_available(matrix.bit_nodes[i], used)
            if idx != -1:
                used.add(idx)
        else:
            candidates.append(i)
    candidates.sort(key=lambda i: len(matrix.bit_nodes[i]))  # stable
    for i in candidates:
        idx = _first_available(matrix.bit_nodes[i], used)
        if idx != -1:
            remove.append(i)
            used.add(idx)
    remove.sort()
    return np.array(remove, dtype=np.int32)


def keep_positions(num_bits: int, bits_to_remove: Optional[np.ndarray]) -> np.ndarray:
    """Static gather indices implementing the reference's compacting
    ``remove_bits`` (src/array_and_matrix_operations.cpp:259-287): the
    device applies ``key[:, keep_positions]`` instead of a sequential scan."""
    if bits_to_remove is None or len(bits_to_remove) == 0:
        return np.arange(num_bits, dtype=np.int32)
    mask = np.ones(num_bits, dtype=bool)
    mask[np.asarray(bits_to_remove, dtype=np.int64)] = False
    return np.flatnonzero(mask).astype(np.int32)
