"""Tracing subsystem: reference-exact traced decodes and console dumps.

Counterpart of ``qkd_ldpc_v_tpu/tracing.py``. The reference exposes three
console trace levels (reference: src/config TRACE_QKD_LDPC,
TRACE_DECODING_ALG, TRACE_DECODING_ALG_LLR; emission sites
src/qkd_ldpc_algorithm.cpp:88-99, :130-135, :1094-1116). Batched decoders
cannot cheaply stream per-iteration tensors, so tracing runs the port's
copy of the float64 oracle (oracle.py), which follows the C++ control flow
and numerics exactly, on the host, and formats the same tensors:
per-iteration E (check->bit messages), L (total LLRs), z (hard decisions),
s (decision syndrome), the max-|LLR| watermarks, and the protocol-level
key/syndrome dumps. The printed text equals the JAX package's character
for character. This doubles as the verification mode: traced results are
the reference-parity f64 trajectories.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from qkd_ldpc_v_tpu_torch.config import Config
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.oracle import (
    TraceIteration,
    calculate_syndrome,
    decode_oracle,
)


def _fmt_array(arr) -> str:
    return " ".join(
        f"{v:g}" if isinstance(v, (float, np.floating)) else str(int(v))
        for v in np.asarray(arr).tolist()
    )


def format_iteration(rec: TraceIteration, llr_watermark: bool = False) -> str:
    """One iteration's dump (reference: src/qkd_ldpc_algorithm.cpp:88-99)."""
    lines = [f"--- iteration {rec.iteration} ---"]
    if rec.check_to_bit:
        lines.append("E (check->bit messages, per bit column):")
        for i, row in enumerate(rec.check_to_bit):
            lines.append(f"  bit {i}: {_fmt_array(np.round(row, 6))}")
    if rec.total_llr is not None:
        lines.append(f"L (total LLRs): {_fmt_array(np.round(rec.total_llr, 6))}")
    if rec.decision is not None:
        lines.append(f"z (hard decision): {_fmt_array(rec.decision)}")
    if rec.decision_syndrome is not None:
        lines.append(f"s (decision syndrome): {_fmt_array(rec.decision_syndrome)}")
    if llr_watermark:
        lines.append(
            f"max|msg LLR| = {rec.max_abs_msg_llr:g}, "
            f"max|total LLR| = {rec.max_abs_total_llr:g}"
        )
    return "\n".join(lines)


def traced_decode(
    matrix: HMatrix,
    llr: np.ndarray,
    syndrome: np.ndarray,
    cfg: Config,
    primary: float = 1.0,
    secondary: float = 1.0,
    emit: Optional[Callable[[str], None]] = print,
):
    """Reference-exact f64 decode of one frame with console tracing.

    Returns (decision, syndromes_match, iterations, trace_records).
    """
    trace: List[TraceIteration] = []
    decision, ok, iters = decode_oracle(
        matrix,
        np.asarray(llr, np.float64),
        np.asarray(syndrome),
        int(cfg.decoding_algorithm),
        cfg.decoding_alg_max_iterations,
        primary=primary,
        secondary=secondary,
        threshold=cfg.msg_llr_threshold,
        use_threshold=cfg.enable_msg_llr_threshold,
        trace=trace,
    )
    if emit is not None and (cfg.trace_decoding_alg or cfg.trace_decoding_alg_llr):
        for rec in trace:
            if cfg.trace_decoding_alg:
                emit(format_iteration(rec, llr_watermark=cfg.trace_decoding_alg_llr))
            elif cfg.trace_decoding_alg_llr:
                emit(
                    f"iteration {rec.iteration}: max|msg LLR| = "
                    f"{rec.max_abs_msg_llr:g}, max|total LLR| = "
                    f"{rec.max_abs_total_llr:g}"
                )
    return decision, ok, iters, trace


def traced_protocol_round(
    matrix: HMatrix,
    alice: np.ndarray,
    bob: np.ndarray,
    qber: float,
    cfg: Config,
    primary: float = 1.0,
    secondary: float = 1.0,
    emit: Callable[[str], None] = print,
):
    """Fixed-rate protocol round through the oracle with the reference's
    protocol-level dump (reference: src/qkd_ldpc_algorithm.cpp:1094-1116).

    Returns (decision, syndromes_match, keys_match, iterations).
    """
    alice = np.asarray(alice)
    bob = np.asarray(bob)
    log_p = float(np.log((1.0 - qber) / qber))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float64)
    syndrome = calculate_syndrome(matrix.check_nodes, alice)
    decision, ok, iters, _ = traced_decode(
        matrix, llr, syndrome, cfg, primary, secondary, emit=emit
    )
    keys_match = bool(np.array_equal(decision, alice))
    if cfg.trace_qkd_ldpc and emit is not None:
        emit("Alice bit array:\n" + _fmt_array(alice))
        emit("Bob bit array with errors:\n" + _fmt_array(bob))
        emit("r (a-priori LLRs):\n" + _fmt_array(np.round(llr, 6)))
        emit("Alice syndrome:\n" + _fmt_array(syndrome))
        emit("Bob corrected bit array:\n" + _fmt_array(decision))
        emit(f"\nIterations performed: {iters}")
        emit(f"Syndromes matched: {'YES' if ok else 'NO'}")
        emit(f"Keys matched: {'YES' if keys_match else 'NO'}")
    return decision, ok, keys_match, iters
