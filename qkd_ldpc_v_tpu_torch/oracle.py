"""NumPy f64 oracle: per-frame, sequential decoders with the reference's
exact control flow and numeric semantics.

A copy of ``qkd_ldpc_v_tpu/oracle.py`` (the port imports nothing of that
package), so that its trace records equal the JAX package's field for
field. It is the backing engine of the tracing subsystem (tracing.py) and
of users' verification mode, and the ground truth the batched float64
torch decoder (``ops/decoders.py``) is tested against. It mirrors the
C++ decoders' per-frame logic (reference: src/qkd_ldpc_algorithm.cpp:3-1029)
directly on the adjacency-list HMatrix: jagged message arrays, sequential
two-minimum tracking, syndrome-folded signs, early exit, and the clamp
points. Deliberately slow and simple.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

DBL_MAX = np.finfo(np.float64).max


def _tanh_lin_approx(x: float) -> float:
    ax = abs(x)
    if ax < 0.5:
        r = 0.9242 * ax
    elif ax < 0.9:
        r = 0.6355 * ax + 0.1444
    elif ax < 1.2:
        r = 0.3912 * ax + 0.3642
    elif ax < 1.75:
        r = 0.1958 * ax + 0.5986
    elif ax < 2.5:
        r = 0.0603 * ax + 0.8358
    elif ax < 3.5:
        r = 0.0115 * ax + 0.9577
    elif ax < 8:
        r = 0.0004 * ax + 0.9967
    else:
        r = 1.0
    return -r if x < 0 else r


def _atanh_lin_approx(x: float) -> float:
    ax = abs(x)
    if ax < 0.7:
        r = 1.196 * ax - 0.0323
    elif ax < 0.9:
        r = 2.9187 * ax - 1.214
    elif ax < 0.999:
        r = 10.8717 * ax - 8.3717
    else:
        r = 2510.9 * ax - 2505.9
    return -r if x < 0 else r


def _clamp_jagged(msgs: List[np.ndarray], threshold: float) -> None:
    for row in msgs:
        np.clip(row, -threshold, threshold, out=row)


def calculate_syndrome(check_nodes, bits) -> np.ndarray:
    syn = np.zeros(len(check_nodes), dtype=np.int64)
    for j, row in enumerate(check_nodes):
        for b in row:
            syn[j] ^= int(bits[b])
    return syn


@dataclass
class TraceIteration:
    """Per-iteration intermediates, mirroring the reference's decoder trace
    dump (reference: src/qkd_ldpc_algorithm.cpp:88-99 — E, L, z, s tensors
    per iteration, plus the max-|LLR| watermark of :130-135)."""

    iteration: int
    check_to_bit: List[np.ndarray] = field(default_factory=list)  # E (jagged)
    total_llr: Optional[np.ndarray] = None  # L
    decision: Optional[np.ndarray] = None  # z
    decision_syndrome: Optional[np.ndarray] = None  # s
    max_abs_msg_llr: float = 0.0
    max_abs_total_llr: float = 0.0


def decode_oracle(
    matrix,
    llr: np.ndarray,
    syndrome: np.ndarray,
    algorithm: int,
    max_iterations: int,
    primary: float = 1.0,
    secondary: float = 1.0,
    threshold: float = 0.0,
    use_threshold: bool = False,
    trace: Optional[List[TraceIteration]] = None,
) -> Tuple[np.ndarray, bool, int]:
    """Decode one frame. Returns (decision, syndromes_match, iterations).

    `matrix` is an HMatrix (ascending adjacency). `algorithm` follows the
    DecodingAlgorithm enum (0..5). When ``trace`` is a list, a
    TraceIteration is appended per iteration.
    """
    bit_nodes = matrix.bit_nodes
    check_nodes = matrix.check_nodes
    n = len(bit_nodes)
    m = len(check_nodes)
    llr = np.asarray(llr, dtype=np.float64)

    # bit_to_check[j][k]: message into check j from its k-th bit (ascending).
    b2c = [llr[row].astype(np.float64).copy() for row in check_nodes]
    # check_to_bit[i][k]: message into bit i from its k-th check (ascending).
    c2b = [np.zeros(len(row), dtype=np.float64) for row in bit_nodes]

    decision = np.zeros(n, dtype=np.int64)
    adaptive = algorithm in (4, 5)
    if adaptive:
        decision = (llr <= 0).astype(np.int64)

    # Slot cursors exactly as the reference's running indices: because
    # adjacency is ascending, check j is bit i's `searchsorted` slot etc.
    c2b_slot = [
        {int(j): k for k, j in enumerate(row)} for row in bit_nodes
    ]  # bit i: check j -> slot
    b2c_slot = [
        {int(i): k for k, i in enumerate(row)} for row in check_nodes
    ]  # check j: bit i -> slot

    for it in range(max_iterations):
        if adaptive:
            syndromes_equal = True
        # ---- check pass ----
        for j in range(m):
            row = check_nodes[j]
            msgs = b2c[j]
            if algorithm in (0, 1):  # SPA variants
                t = np.empty(len(msgs))
                for k in range(len(msgs)):
                    t[k] = (
                        math.tanh(msgs[k] / 2.0)
                        if algorithm == 0
                        else _tanh_lin_approx(msgs[k] / 2.0)
                    )
                row_prod = -1.0 if syndrome[j] else 1.0
                for k in range(len(t)):
                    row_prod *= t[k]
                b2c[j] = t  # reference overwrites in place (:60)
                for k, i in enumerate(row):
                    prod = row_prod / t[k]
                    val = 2.0 * (
                        math.atanh(prod) if algorithm == 0 else _atanh_lin_approx(prod)
                    )
                    c2b[i][c2b_slot[i][j]] = val
            else:  # min-sum family
                sign_prod = -1.0 if syndrome[j] else 1.0
                neg = 0
                min1 = DBL_MAX
                min2 = DBL_MAX
                for k in range(len(msgs)):
                    if msgs[k] < 0:
                        neg += 1
                    cur = abs(msgs[k])
                    if cur < min1:
                        min2 = min1
                        min1 = cur
                    elif cur < min2:
                        min2 = cur
                sign_prod *= 1.0 if neg % 2 == 0 else -1.0

                if adaptive:
                    dsyn_j = 0
                    for i in row:
                        dsyn_j ^= int(decision[i])
                    if dsyn_j != syndrome[j]:
                        factor = secondary
                        syndromes_equal = False
                    else:
                        factor = primary
                else:
                    factor = primary

                for k, i in enumerate(row):
                    prod = sign_prod * (1.0 if msgs[k] > 0 else -1.0)
                    eabs = min2 if abs(msgs[k]) == min1 else min1
                    if algorithm in (2, 4):  # normalized
                        val = factor * prod * eabs
                    else:  # offset
                        diff = eabs - factor
                        val = prod * (0.0 if diff < 0.0 else diff)
                    c2b[i][c2b_slot[i][j]] = val

        if adaptive and syndromes_equal:
            if trace is not None:
                trace.append(
                    TraceIteration(
                        iteration=it + 1,
                        decision=decision.copy(),
                        decision_syndrome=np.asarray(syndrome).copy(),
                    )
                )
            return decision.copy(), True, it + 1

        if use_threshold:
            _clamp_jagged(c2b, threshold)

        # ---- bit pass part 1: totals + hard decision ----
        total = np.empty(n, dtype=np.float64)
        for i in range(n):
            s = llr[i]
            for v in c2b[i]:
                s += v
            total[i] = s
            decision[i] = 1 if s <= 0 else 0

        dsyn = calculate_syndrome(check_nodes, decision)
        if trace is not None:
            trace.append(
                TraceIteration(
                    iteration=it + 1,
                    check_to_bit=[row.copy() for row in c2b],
                    total_llr=total.copy(),
                    decision=decision.copy(),
                    decision_syndrome=dsyn.copy(),
                    max_abs_msg_llr=float(
                        max((np.abs(r).max() for r in c2b if len(r)), default=0.0)
                    ),
                    max_abs_total_llr=float(np.abs(total).max()),
                )
            )

        if not adaptive:
            if np.array_equal(dsyn, np.asarray(syndrome)):
                return decision.copy(), True, it + 1

        # ---- bit pass part 2: new bit->check messages ----
        for i in range(n):
            col_sum = total[i]
            for k, j in enumerate(bit_nodes[i]):
                b2c[j][b2c_slot[j][i]] = col_sum - c2b[i][k]

        if use_threshold:
            _clamp_jagged(b2c, threshold)

    return decision.copy(), False, max_iterations
