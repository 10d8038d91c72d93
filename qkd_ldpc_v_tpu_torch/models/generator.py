"""Random LDPC code generation (Gallager-style column-regular construction).

A copy of ``qkd_ldpc_v_tpu/models/generator.py``: the same seed gives the
same code in both packages.

The reference ships pre-built matrix assets but no generator; this module
gives the framework self-contained test/bench codes at the reference's
operating points (N in {1k, 10k, 100k}, column weight 3-5, R in 0.36-0.92 —
see SURVEY.md section 6) without copying any reference data files.
"""

from __future__ import annotations

from typing import List

import numpy as np

from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix


def generate_regular_ldpc(
    num_bits: int,
    num_checks: int,
    column_weight: int = 3,
    seed: int = 0,
    max_tries: int = 64,
) -> HMatrix:
    """Generate a column-regular LDPC parity-check matrix.

    Each bit column connects to exactly ``column_weight`` distinct checks;
    check-row weights are near-uniform (``ceil/floor`` of E/M). Construction:
    a random permutation of a balanced check-socket multiset, with repair
    passes resolving duplicate (bit, check) pairs by swapping sockets.
    Degree-0 rows are impossible by balance; duplicate edges are eliminated,
    so the result is a simple bipartite graph.
    """
    if column_weight >= num_checks:
        raise ValueError("column_weight must be < num_checks")
    rng = np.random.default_rng(seed)
    num_edges = num_bits * column_weight

    # Balanced multiset of check sockets: each check appears floor or ceil of
    # E/M times.
    base, extra = divmod(num_edges, num_checks)
    counts = np.full(num_checks, base, dtype=np.int64)
    counts[rng.permutation(num_checks)[:extra]] += 1
    sockets = np.repeat(np.arange(num_checks, dtype=np.int32), counts)

    for _ in range(max_tries):
        perm = rng.permutation(num_edges)
        assignment = sockets[perm].reshape(num_bits, column_weight)
        # Repair duplicates within each column by swapping with random
        # positions elsewhere.
        flat = assignment.ravel()
        ok = True
        for _repair in range(100):
            cols = flat.reshape(num_bits, column_weight)
            sorted_cols = np.sort(cols, axis=1)
            dup_rows = np.flatnonzero((np.diff(sorted_cols, axis=1) == 0).any(axis=1))
            if dup_rows.size == 0:
                break
            for i in dup_rows:
                row = cols[i]
                seen = set()
                for s in range(column_weight):
                    v = int(row[s])
                    if v in seen:
                        # Swap this socket with a random other edge slot.
                        j = int(rng.integers(num_edges))
                        flat[i * column_weight + s], flat[j] = (
                            flat[j],
                            flat[i * column_weight + s],
                        )
                    else:
                        seen.add(v)
        else:
            ok = False
        if ok:
            bit_nodes: List[np.ndarray] = [
                np.sort(flat.reshape(num_bits, column_weight)[i]).astype(np.int32)
                for i in range(num_bits)
            ]
            buckets: List[List[int]] = [[] for _ in range(num_checks)]
            for i, checks in enumerate(bit_nodes):
                for c in checks:
                    buckets[int(c)].append(i)
            check_nodes = [np.array(sorted(b), dtype=np.int32) for b in buckets]
            if any(len(b) == 0 for b in check_nodes):
                continue
            row_w = {len(r) for r in check_nodes}
            is_regular = len(row_w) == 1  # column-regular by construction
            return HMatrix(bit_nodes, check_nodes, is_regular)
    raise RuntimeError(
        "Failed to generate a simple regular LDPC graph; try another seed"
    )
