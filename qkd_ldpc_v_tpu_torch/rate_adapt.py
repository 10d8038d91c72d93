"""Code-rate adaptation: the puncturing/shortening calculator and untainted
puncturing (host-side preprocessing that yields static index vectors).

A copy of ``qkd_ldpc_v_tpu/rate_adapt.py`` (importing that package imports
JAX): the rate-modulation scheme of Elkouss et al., arXiv:1007.1616
(reference: src/array_and_matrix_operations.cpp:1129-1223) and untainted
puncturing per arXiv:1103.6149 (reference: :975-1123), with the
reference-compatible ``.untp`` disk cache (one line of space-separated
indices next to the ``.mtrx`` file).

The untainted greedy runs in pure Python here. The JAX package may run it
in its native helper instead, which is bit-identical to the Python greedy,
so both packages select the same positions from the same seed. The helper
is not ported: at N=102400 this NumPy-backed greedy takes less time than
it does (``scripts/time_host_readers.py``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.privacy import bits_positions_to_remove_rate_adapt

logger = logging.getLogger("qkd_ldpc_v_tpu_torch")

# LLR assigned to punctured positions; avoids division by zero in the SPA
# product-exclusion (reference: src/qkd_ldpc_algorithm.hpp:13, :1150-1156).
ALMOST_ZERO = 1e-4


@dataclass
class HMatrixParams:
    """Per-combination matrix modulation parameters
    (reference: src/array_and_matrix_operations.hpp:27-57)."""

    delta: float = 0.0
    efficiency: float = 0.0
    punctured_fraction: float = 0.0
    shortened_fraction: float = 0.0
    adapted_code_rate: float = 0.0
    punctured_bits: np.ndarray = field(default_factory=lambda: np.array([], np.int32))
    shortened_bits: np.ndarray = field(default_factory=lambda: np.array([], np.int32))
    bits_to_remove: np.ndarray = field(default_factory=lambda: np.array([], np.int32))

    @property
    def is_empty(self) -> bool:
        """True when the adaptation was skipped as unachievable
        (reference skip rule: src/simulation.cpp:414, 440)."""
        return len(self.punctured_bits) == 0 and len(self.shortened_bits) == 0


def binary_entropy(q: float) -> float:
    """Shannon binary entropy h_b(q)
    (reference: src/array_and_matrix_operations.cpp:1138)."""
    return -q * np.log2(q) - (1.0 - q) * np.log2(1.0 - q)


def adapt_code_rate(
    rng: np.random.Generator,
    matrix: HMatrix,
    qber: float,
    delta: float,
    efficiency: float,
    use_untainted: bool = False,
) -> HMatrixParams:
    """Compute puncture/shorten counts and positions for one operating point
    (reference: src/array_and_matrix_operations.cpp:1129-1223).

    Target rate R_t = 1 - f_EC * h_b(QBER); shortened count
    s = ceil((R0 - R_t(1-delta)) * N); punctured count p = delta*N - s.
    Returns an empty HMatrixParams (combination skipped) when the target is
    outside the achievable range or the untainted pool is too small.
    """
    h_b = binary_entropy(qber)
    optimal_r = 1.0 - efficiency * h_b
    n = matrix.num_bit_nodes
    m = matrix.num_check_nodes
    original_r = 1.0 - m / n

    num_short = int(np.ceil((original_r - optimal_r * (1.0 - delta)) * n))
    num_punct = int(delta * n - num_short)

    params = HMatrixParams()
    min_r = (original_r - delta) / (1.0 - delta)
    max_r = original_r / (1.0 - delta)
    if num_short <= 0 or num_punct <= 0:
        logger.warning(
            "R0 = %.3f, QBER = %.4f, delta = %.3f, f_EC = %.3f. Adapted code "
            "rate R = %.3f beyond the achievable rate range: Rmin = %.3f, "
            "Rmax = %.3f. This parameters will not be used in simulations.",
            original_r, qber, delta, efficiency, optimal_r, min_r, max_r,
        )
        return params

    if use_untainted:
        pool = matrix.punctured_bits_untainted
        if pool is None:
            raise ValueError(
                "untainted puncturing requested but matrix has no untainted "
                "position cache; call get_punctured_bits_untainted first"
            )
        if num_punct > len(pool):
            logger.warning(
                "R0 = %.3f, QBER = %.4f, delta = %.3f, f_EC = %.3f, R = %.3f, "
                "Rmin = %.3f, Rmax = %.3f. The calculated number of punctured "
                "bits (%d) exceeds the number of bits produced by untainted "
                "algorithm (%d). These parameters will not be used in "
                "simulations.",
                original_r, qber, delta, efficiency, optimal_r, min_r, max_r,
                num_punct, len(pool),
            )
            return params
        punctured = np.sort(np.asarray(pool[:num_punct], dtype=np.int32))
    else:
        punctured = np.sort(
            rng.permutation(n)[:num_punct].astype(np.int32)
        )

    remaining = np.setdiff1d(np.arange(n, dtype=np.int32), punctured)
    shortened = np.sort(rng.permutation(remaining)[:num_short].astype(np.int32))

    params.punctured_bits = punctured
    params.shortened_bits = shortened
    params.delta = delta
    params.efficiency = efficiency
    params.shortened_fraction = num_short / n
    params.punctured_fraction = num_punct / n
    params.adapted_code_rate = (n - m - num_short) / (n - num_punct - num_short)
    return params


def finalize_bits_to_remove(
    matrix: HMatrix, params: HMatrixParams, privacy_maintenance: bool
) -> None:
    """Fill params.bits_to_remove (reference: src/simulation.cpp:417-425):
    privacy on -> the rate-adapt greedy; off -> merge of punctured+shortened."""
    if privacy_maintenance:
        params.bits_to_remove = bits_positions_to_remove_rate_adapt(
            matrix, params.punctured_bits, params.shortened_bits
        )
    else:
        params.bits_to_remove = np.sort(
            np.concatenate([params.punctured_bits, params.shortened_bits])
        ).astype(np.int32)


# ---------------------------------------------------------------------------
# Untainted puncturing (arXiv:1103.6149)
# ---------------------------------------------------------------------------


def second_order_csr(matrix: HMatrix) -> tuple:
    """Second-order neighborhoods in CSR form (flat, offsets).

    N2(v) = all bits sharing a check with v, minus v (reference:
    src/array_and_matrix_operations.cpp:975-997). Built fully vectorized:
    each check row of degree d contributes its d*(d-1) ordered bit pairs;
    lexsort + dedup yields per-source sorted unique neighbor lists.
    """
    n = matrix.num_bit_nodes
    srcs = []
    dsts = []
    by_degree: dict = {}
    for row in matrix.check_nodes:
        by_degree.setdefault(len(row), []).append(row)
    for d, rows in by_degree.items():
        if d < 2:
            continue
        rows = np.asarray(rows, dtype=np.int32)  # [c, d]
        a = np.broadcast_to(rows[:, :, None], (len(rows), d, d))
        b = np.broadcast_to(rows[:, None, :], (len(rows), d, d))
        mask = ~np.eye(d, dtype=bool)
        srcs.append(a[:, mask].reshape(-1))
        dsts.append(b[:, mask].reshape(-1))
    if not srcs:
        return (
            np.array([], dtype=np.int32),
            np.zeros(n + 1, dtype=np.int64),
        )
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    keep = np.ones(len(src), dtype=bool)
    keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    src, dst = src[keep], dst[keep]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    return dst.astype(np.int32), offsets


def second_order_neighbors(matrix: HMatrix) -> List[np.ndarray]:
    """N2(v) per bit node as a list of sorted arrays (reference:
    src/array_and_matrix_operations.cpp:975-997)."""
    flat, offsets = second_order_csr(matrix)
    return [
        flat[offsets[i] : offsets[i + 1]] for i in range(matrix.num_bit_nodes)
    ]


_M64 = (1 << 64) - 1


def _splitmix64(state: int) -> tuple:
    """One SplitMix64 step (state', output): the greedy's tie-break
    generator."""
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, z ^ (z >> 31)


def _untainted_greedy_py(flat: np.ndarray, offsets: np.ndarray, seed: int) -> np.ndarray:
    """The greedy in pure Python: incremental |N2 ∩ X| counts (N2 is
    symmetric, so a node leaving X decrements exactly its own N2 row) and a
    SplitMix64 modulo tie-break."""
    n = len(offsets) - 1
    counts = (offsets[1:] - offsets[:-1]).astype(np.int64)
    in_x = np.ones(n, dtype=bool)
    n_active = n
    state = seed & _M64
    big = np.iinfo(np.int64).max
    out: List[int] = []
    while n_active > 0:
        masked = np.where(in_x, counts, big)
        mn = masked.min()
        candidates = np.flatnonzero(masked == mn)
        state, r = _splitmix64(state)
        chosen = int(candidates[r % len(candidates)])
        out.append(chosen)
        row = flat[offsets[chosen] : offsets[chosen + 1]]
        removed = np.concatenate(([chosen], row[in_x[row]]))
        in_x[removed] = False
        n_active -= len(removed)
        dec = np.concatenate(
            [flat[offsets[r0] : offsets[r0 + 1]] for r0 in removed]
        )
        np.subtract.at(counts, dec, 1)
    return np.array(out, dtype=np.int32)


def select_punctured_bits_untainted(
    rng: np.random.Generator, matrix: HMatrix
) -> np.ndarray:
    """Greedy max-set of pairwise 'untainted' puncturable bits
    (reference: src/array_and_matrix_operations.cpp:1002-1068).

    Iteratively picks a (seeded-random) bit with the minimum number of
    second-order neighbors still in the candidate set X, then removes it and
    its whole N2 from X. Consumes one draw from ``rng`` as the SplitMix64
    tie-break seed.
    """
    flat, offsets = second_order_csr(matrix)
    seed = int(rng.integers(0, 1 << 63))
    return _untainted_greedy_py(flat, offsets, seed)


def get_punctured_bits_untainted(
    matrix_path,
    rng: np.random.Generator,
    matrix: HMatrix,
) -> np.ndarray:
    """Read-or-generate the untainted position list, cached as a ``.untp``
    file next to the matrix (reference: src/array_and_matrix_operations.cpp:
    1076-1123; same on-disk format, so reference-shipped caches are reused).
    A cache that is read consumes nothing from ``rng``.
    """
    path = Path(matrix_path).with_suffix(".untp")
    positions: Optional[np.ndarray] = None
    if path.exists():
        text = path.read_text().strip()
        if text:
            positions = np.array([int(t) for t in text.split()], dtype=np.int32)

    if positions is not None and len(positions):
        bad = (positions < 0) | (positions >= matrix.num_bit_nodes)
        if bad.any():
            raise ValueError(
                f"The punctured bit index '{int(positions[bad][0])}' is out "
                f"of range [0,{matrix.num_bit_nodes - 1}]. File: {path}"
            )
        return positions

    logger.warning(
        "No file with punctured untainted bits found: %s \nThis file will be "
        "automatically created. Wait...",
        path,
    )
    positions = select_punctured_bits_untainted(rng, matrix)
    try:
        path.write_text(" ".join(str(int(p)) for p in positions) + " ")
        logger.warning("File created successfully.")
    except OSError:
        logger.warning("Unable to open file for writing: %s (cache skipped)", path)
    return positions
