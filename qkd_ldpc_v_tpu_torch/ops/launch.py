"""The launch layer the four decode kernels' modules stand on: their
wrapper body (fused QC, streamed QC, fused generic, streamed generic), and
the code facts more than one kernel reads.

A kernel module (``ops/fused_qc.py``, ``ops/qc_stream.py``,
``ops/fused_generic.py``, ``ops/generic_stream.py``, ``ops/spa.py``) holds
only what is its own kernel's: its launch plan, its limits, its tables and
its ``make_*`` factories. It imports this module (``ops/spa.py``, which
needs no launch plan, does not), ``ops/counts.py`` and the plain modules,
never another kernel module; this module imports no kernel module.

Routing is by the tensors' device and nothing else: CPU tensors go to the
plain version, CUDA tensors launch the kernel, and any other device raises.
There is no fallback from a failed launch. ``kernel_trial``,
``kernel_montecarlo``, ``kernel_frame_trial`` and ``kernel_decoder`` hold
that wrapper body once for every kernel; ``qc_trial``, ``qc_montecarlo``,
``qc_frame_trial`` and ``qc_decoder`` give it the QC plain versions
(``ops/qc_decoder.py``), and ``generic_trial``, ``generic_montecarlo`` and
``generic_decoder`` the generic ones (``ops/decoders.py``). Each kernel
gives it a launch plan, built once per code, flags and device
(``cached_plans``), whose ``launch(mode, batch, inputs, scalars, outs)``
calls the kernel's C entry of that mode (``kernels.SIGNATURES``) and
returns its CUDA error code.

Counters and spans: each wrapper counts its calls in a ``KernelCounts``
and records each counted call as the span ``kernel_span(kernel, mode)``
(``ops/counts.py``, which every kernel module and ``ops/channel.py`` import
as this module does).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.channel import mc_channel, qc_syndrome
from qkd_ldpc_v_tpu_torch.ops.counts import (
    KernelCounts,
    kernel_span,
    raise_on_error,
)
from qkd_ldpc_v_tpu_torch.ops.decoders import (
    DecodeResult,
    frame_trial,
    get_decoder,
    make_trial,
)
from qkd_ldpc_v_tpu_torch.ops.philox import key_of
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import (
    SPA_PAIR,
    base_tables,
    check_layered,
    decode_flooding,
    decode_layered,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache, span


# Shared memory one block may use on sm_90 (227 KB; csrc/*.cu:
# kMaxSharedBytes).
MAX_SHARED_BYTES = 232448
# The fused kernels' modes (csrc/fused_qc.cu and csrc/fused_generic.cu:
# Mode), by which their shared layouts differ.
MODES = {"decode": 0, "trial": 1, "frame": 2, "mc": 3}


def align16(x: int) -> int:
    return (x + 15) // 16 * 16


def check_flags(algorithm: DecodingAlgorithm) -> int:
    """The check update's template flag of every kernel of this package: 0
    min-sum, 1 SPA, 2 SPA-lin-approx (csrc/spa.cuh: kMinSum, kSpa,
    kSpaLin)."""
    return SPA_PAIR.index(algorithm) + 1 if algorithm in SPA_PAIR else 0


def pointers(*tensors: torch.Tensor) -> List[int]:
    return [t.data_ptr() for t in tensors]


def cached_plans(make: Callable) -> Callable:
    """``plan_for(code, flags, device)``: ``make(code, flags, device)``,
    built once per code (by identity), flags and device."""
    plans = PlanCache()

    def plan_for(code, flags: int, device):
        key = (flags, str(device))
        plan = plans.get(code, extra=key)
        if plan is None:
            with span("kernel.plan"):
                plan = make(code, flags, device)
            plans.put(code, plan, extra=key)
        return plan

    return plan_for


def check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_stats(kernel: str, what: str, name: str, counts: KernelCounts,
                  device: torch.device, batch: int, launch: Callable):
    """Per-frame statistics ``(conv, keys, iters)`` of ``batch`` frames from
    one launch of a kernel's mode ``what``: ``launch(outs)`` fills ``outs =
    (conv int8, keys int8, iters int32)`` on ``device`` and returns the CUDA
    error code, which raises; the launch is counted, and recorded as the
    span ``name``."""
    conv = torch.empty(batch, dtype=torch.int8, device=device)
    keys = torch.empty(batch, dtype=torch.int8, device=device)
    iters = torch.empty(batch, dtype=torch.int32, device=device)
    if batch == 0:
        return conv.bool(), keys.bool(), iters
    with span(name):
        raise_on_error(launch((conv, keys, iters)), f"{kernel} {what}")
        counts.count_launch(what)
    return conv.bool(), keys.bool(), iters


def _launch_scalars(flags: int, use_threshold: bool, max_iterations: int,
                    *scalars) -> tuple:
    return (flags, int(use_threshold), int(max_iterations),
            *(float(x) for x in scalars))


def _stats_wrapper(kernel: str, what: str, counts: KernelCounts,
                   plan_for: Callable, code, flags: int, n: int,
                   max_iterations: int, use_threshold: bool,
                   second: Tuple[str, torch.dtype], plain: Callable) -> Tuple[
                       Callable, Callable]:
    """The body of the wrappers that return per-frame statistics from
    tensors: checks, routing by device, outputs and counting. ``call(alice,
    other, scalars)`` takes Alice's keys or frame [B, n] int8, the second
    input ``second = (name, dtype)`` [B, n] and the call's float scalars,
    and launches the plan's mode ``what``; ``counted_plain(alice, other,
    *scalars)`` runs ``plain`` and counts it. Both record the span
    ``kernel_span(kernel, what)``."""
    name = kernel_span(kernel, what)

    def counted_plain(alice, other, *scalars):
        with span(name):
            counts.count_plain(alice.device, what)
            return plain(alice, other, *scalars)

    def call(alice, other, scalars):
        b = alice.shape[0]
        check_tensor("alice", alice, torch.int8, (b, n), alice.device)
        check_tensor(second[0], other, second[1], (b, n), alice.device)
        if alice.device.type == "cpu":
            return counted_plain(alice, other, *scalars)
        if alice.device.type != "cuda":
            raise NotImplementedError(
                f"{kernel} {what}: no kernel for device {alice.device}")
        plan = plan_for(code, flags, alice.device)
        launch_scalars = _launch_scalars(flags, use_threshold,
                                         max_iterations, *scalars)
        inputs = (*pointers(alice, other), b)
        return _launch_stats(
            kernel, what, name, counts, alice.device, b,
            lambda outs: plan.launch(what, b, inputs, launch_scalars, outs))

    return call, counted_plain


def kernel_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                 code, flags: int, n: int, max_iterations: int,
                 use_threshold: bool, plain: Callable) -> Callable:
    """The trial wrapper body every kernel of this package shares: checks,
    routing by device, outputs and counting, for the kernel named
    ``kernel``, counted in ``counts``, on ``code`` with ``n`` bits.
    ``plan_for(code, flags, device)`` gives its launch plan, whose
    ``launch("trial", batch, (alice, bob, batch), scalars, outs)`` launches
    it with ``scalars = (flags, use_threshold, max_iterations, log_p,
    primary, secondary, threshold)`` and ``outs = (conv, keys, iters)``
    (tensors as their pointers) and returns the CUDA error code. ``plain``
    is the plain version, with the trial's signature."""
    call, counted_plain = _stats_wrapper(
        kernel, "trial", counts, plan_for, code, flags, n, max_iterations,
        use_threshold, ("bob", torch.int8), plain)

    def trial(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        return call(alice, bob, (log_p, primary, secondary, threshold))

    trial.plain = counted_plain
    return trial


def kernel_montecarlo(kernel: str, counts: KernelCounts, plan_for: Callable,
                      code, flags: int, n: int, max_iterations: int,
                      use_threshold: bool, plain: Callable) -> Callable:
    """The mc wrapper body, as ``kernel_trial``: ``mc(seed, frame0, batch,
    num_errors, log_p, primary, secondary, threshold, device="cuda")``
    decodes frames ``frame0 .. frame0 + batch - 1`` of the chunk whose seed
    is ``seed`` (``channel.chunk_seed``) with keys drawn from its Philox
    stream, ``num_errors`` errors each, and returns ``(syndromes_match,
    keys_match, iterations)`` on ``device``. The plan's ``launch("mc",
    batch, draw, scalars, outs)`` launches the kernel's mc mode with ``draw
    = (k0, k1, frame0, num_errors, batch)`` and the trial's ``scalars``.
    ``mc.plain`` is ``channel.mc_channel`` followed by ``plain``, the plain
    trial; a CPU ``device`` runs it, CUDA launches the kernel, and any other
    device raises. Both record the span ``kernel_span(kernel, "mc")``."""
    name = kernel_span(kernel, "mc")

    def check(seed, frame0, batch, num_errors):
        key_of(seed)
        if batch < 0 or frame0 < 0 or frame0 + batch > 1 << 31:
            raise ValueError(f"frames {frame0} .. {frame0 + batch - 1} are "
                             "outside 0 .. 2**31 - 1")
        if not 0 <= num_errors <= n:
            raise ValueError(f"num_errors = {num_errors} is outside 0 .. {n}")

    def counted_plain(seed, frame0, batch, num_errors, log_p, primary=1.0,
                      secondary=1.0, threshold=0.0, device="cpu"):
        device = torch.device(device)
        check(seed, frame0, batch, num_errors)
        with span(name):
            counts.count_plain(device, "mc")
            alice, bob = mc_channel(seed, frame0, batch, n, num_errors,
                                    device)
            return plain(alice, bob, log_p, primary, secondary, threshold)

    def mc(seed, frame0, batch, num_errors, log_p, primary=1.0,
           secondary=1.0, threshold=0.0, device="cuda"):
        device = torch.device(device)
        if device.type == "cpu":
            return counted_plain(seed, frame0, batch, num_errors, log_p,
                                 primary, secondary, threshold, device)
        if device.type != "cuda":
            raise NotImplementedError(
                f"{kernel} mc: no kernel for device {device}")
        check(seed, frame0, batch, num_errors)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        plan = plan_for(code, flags, device)
        draw = (*key_of(seed), int(frame0), int(num_errors), int(batch))
        scalars = _launch_scalars(flags, use_threshold, max_iterations,
                                  log_p, primary, secondary, threshold)
        return _launch_stats(
            kernel, "mc", name, counts, device, batch,
            lambda outs: plan.launch("mc", batch, draw, scalars, outs))

    mc.plain = counted_plain
    return mc


def kernel_frame_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                       code, flags: int, n: int, max_iterations: int,
                       use_threshold: bool, plain: Callable) -> Callable:
    """The frame-trial wrapper body, as ``kernel_trial``: the plan's
    ``launch("frame", batch, (alice_frame, llr, batch), scalars, outs)``
    launches the kernel's frame mode with ``scalars = (flags,
    use_threshold, max_iterations, primary, secondary, threshold)``;
    ``plain(alice_frame, llr, primary, secondary, threshold)`` returns
    ``(conv, keys, iters)``."""
    call, counted_plain = _stats_wrapper(
        kernel, "frame", counts, plan_for, code, flags, n, max_iterations,
        use_threshold, ("llr", torch.float32), plain)

    def trial(alice_frame, llr, primary=1.0, secondary=1.0, threshold=0.0):
        return call(alice_frame, llr, (primary, secondary, threshold))

    trial.plain = counted_plain
    return trial


def kernel_decoder(kernel: str, counts: KernelCounts, plan_for: Callable,
                   code, flags: int, n: int, m: int, max_iterations: int,
                   use_threshold: bool, plain: Callable) -> Callable:
    """The decode wrapper body, as ``kernel_trial``; the plan's
    ``launch("decode", batch, (llr, syndrome, batch), scalars, outs)``
    takes ``scalars = (flags, use_threshold, max_iterations, primary,
    secondary, threshold)`` and ``outs = (decisions, conv, iters)``;
    ``plain(llr, syndrome, primary, secondary, threshold)`` returns a
    ``DecodeResult``. Both record the span ``kernel_span(kernel,
    "decode")``."""
    name = kernel_span(kernel, "decode")

    def counted_plain(llr, syndrome, primary=1.0, secondary=1.0,
                      threshold=0.0):
        with span(name):
            counts.count_plain(llr.device, "decode")
            return plain(llr, syndrome, primary, secondary, threshold)

    def decode(llr, syndrome, primary=1.0, secondary=1.0, threshold=0.0):
        b = llr.shape[0]
        check_tensor("llr", llr, torch.float32, (b, n), llr.device)
        check_tensor("syndrome", syndrome, torch.int8, (b, m), llr.device)
        if llr.device.type == "cpu":
            return counted_plain(llr, syndrome, primary, secondary, threshold)
        if llr.device.type != "cuda":
            raise NotImplementedError(
                f"{kernel} decoder: no kernel for device {llr.device}")
        plan = plan_for(code, flags, llr.device)
        dec = torch.empty((b, n), dtype=torch.int8, device=llr.device)
        conv = torch.empty(b, dtype=torch.int8, device=llr.device)
        iters = torch.empty(b, dtype=torch.int32, device=llr.device)
        if b == 0:
            return DecodeResult(dec, conv.bool(), iters)
        scalars = _launch_scalars(flags, use_threshold, max_iterations,
                                  primary, secondary, threshold)
        with span(name):
            raise_on_error(plan.launch("decode", b,
                                       (*pointers(llr, syndrome), b),
                                       scalars, (dec, conv, iters)),
                           f"{kernel} decode")
            counts.count_launch("decode")
        return DecodeResult(dec, conv.bool(), iters)

    decode.plain = counted_plain
    return decode


# ---------------------------------------------------------------------------
# The QC kernels (fused and streamed): their flags, code facts and plain
# versions.
# ---------------------------------------------------------------------------


def check_schedule(schedule: str) -> bool:
    """True for layered; raises on an unknown schedule."""
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return schedule == "layered"


def kernel_flags(algorithm: DecodingAlgorithm, layered: bool) -> int:
    """The QC kernels' template flags: bit 0 layered, bit 1 adaptive, bit 2
    offset (OMSA/AOMSA), bits 3-4 the check update (``check_flags``: 8 SPA,
    16 SPA-lin). Raises ``ValueError`` for the layered schedule with the SPA
    pair, which floods, before any launch."""
    check_layered(algorithm, layered)
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return (int(layered) | (int(algorithm.is_adaptive) << 1)
            | (int(offset) << 2) | (check_flags(algorithm) << 3))


def shape_of(qc: QCMatrix) -> Tuple[int, int, int, int, int]:
    """(mb, nb, Z, block edges, largest row degree)."""
    rows, _, num_be = base_tables(qc)
    return (qc.base_checks, qc.base_bits, qc.lifting, num_be,
            max((len(r) for r in rows), default=0))


def block_edge_table(qc: QCMatrix) -> List[int]:
    """The QC kernels' block-edge table: row_ptr[mb+1], cols[num_be],
    shifts[num_be], in storage order."""
    rows, _, _ = base_tables(qc)
    row_ptr = [0]
    cols, shifts = [], []
    for row in rows:
        for (_, c, s) in row:
            cols.append(c)
            shifts.append(s)
        row_ptr.append(len(cols))
    return row_ptr + cols + shifts


def limit_reason(qc: QCMatrix, max_lifting: int, max_block_edges: int,
                 max_base_checks: int) -> Optional[str]:
    """Which of a QC kernel's size limits this code exceeds, or None."""
    sizes = (
        (qc.lifting, max_lifting, "lifting size Z"),
        (len(qc.block_edges), max_block_edges, "block edges"),
        (qc.base_checks, max_base_checks, "base checks"),
    )
    for value, limit, what in sizes:
        if value > limit:
            return f"{what} = {value} exceeds {limit}"
    return None


def plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                 use_threshold, layered, primary, secondary, threshold):
    """The QC kernels' plain version (``ops/qc_decoder.py``)."""
    fn = decode_layered if layered else decode_flooding
    return fn(qc, llr, syndrome, algorithm, max_iterations, use_threshold,
              primary, secondary, threshold)


def _plain_frame_trial(qc, algorithm, max_iterations, use_threshold,
                       layered) -> Callable:
    """The QC kernels' plain frame trial: Alice's syndrome from her keys or
    frame (``qc_syndrome``), the plain decoder, the key compare."""

    def decode(llr, syndrome, primary, secondary, threshold):
        return plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                            use_threshold, layered, primary, secondary,
                            threshold)

    return frame_trial(decode, lambda alice: qc_syndrome(qc, alice))


def _plain_trial(qc, algorithm, max_iterations, use_threshold,
                 layered) -> Callable:
    """The QC kernels' plain trial: ``plain(alice, bob, log_p, primary,
    secondary, threshold)``, the LLRs -/+log_p by Bob's bit, then
    ``_plain_frame_trial``."""
    tail = _plain_frame_trial(qc, algorithm, max_iterations, use_threshold,
                              layered)

    def plain(alice, bob, log_p, primary, secondary, threshold):
        lp = torch.tensor(log_p, dtype=torch.float32, device=alice.device)
        return tail(alice, torch.where(bob == 1, -lp, lp), primary, secondary,
                    threshold)

    return plain


def qc_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
             qc: QCMatrix, algorithm: DecodingAlgorithm, max_iterations: int,
             use_threshold: bool, schedule: str) -> Callable:
    """``kernel_trial`` of a QC kernel, with the QC plain version
    (``ops/qc_decoder.py``) in the schedule asked for."""
    layered = check_schedule(schedule)
    return kernel_trial(kernel, counts, plan_for, qc,
                        kernel_flags(algorithm, layered), qc.num_bit_nodes,
                        max_iterations, use_threshold,
                        _plain_trial(qc, algorithm, max_iterations,
                                     use_threshold, layered))


def qc_montecarlo(kernel: str, counts: KernelCounts, plan_for: Callable,
                  qc: QCMatrix, algorithm: DecodingAlgorithm,
                  max_iterations: int, use_threshold: bool,
                  schedule: str) -> Callable:
    """``kernel_montecarlo`` of a QC kernel, with the QC plain trial in the
    schedule asked for."""
    layered = check_schedule(schedule)
    return kernel_montecarlo(kernel, counts, plan_for, qc,
                             kernel_flags(algorithm, layered),
                             qc.num_bit_nodes, max_iterations, use_threshold,
                             _plain_trial(qc, algorithm, max_iterations,
                                          use_threshold, layered))


def qc_frame_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                   qc: QCMatrix, algorithm: DecodingAlgorithm,
                   max_iterations: int, use_threshold: bool,
                   schedule: str) -> Callable:
    """``kernel_frame_trial`` of a QC kernel. Its plain version is Alice's
    syndrome from her frame (``qc_syndrome``), the QC plain decoder in the
    schedule asked for, and the key compare over the whole frame."""
    layered = check_schedule(schedule)
    return kernel_frame_trial(kernel, counts, plan_for, qc,
                              kernel_flags(algorithm, layered),
                              qc.num_bit_nodes, max_iterations, use_threshold,
                              _plain_frame_trial(qc, algorithm, max_iterations,
                                                 use_threshold, layered))


def qc_decoder(kernel: str, counts: KernelCounts, plan_for: Callable,
               qc: QCMatrix, algorithm: DecodingAlgorithm,
               max_iterations: int, use_threshold: bool,
               schedule: str) -> Callable[..., DecodeResult]:
    """``kernel_decoder`` of a QC kernel, as ``qc_trial``."""
    layered = check_schedule(schedule)

    def plain(llr, syndrome, primary, secondary, threshold):
        return plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                            use_threshold, layered, primary, secondary,
                            threshold)

    return kernel_decoder(kernel, counts, plan_for, qc,
                          kernel_flags(algorithm, layered), qc.num_bit_nodes,
                          qc.num_check_nodes, max_iterations, use_threshold,
                          plain)


# ---------------------------------------------------------------------------
# The generic kernels (fused and streamed): their flags, layout facts and
# plain versions.
# ---------------------------------------------------------------------------


def generic_flags(algorithm: DecodingAlgorithm) -> int:
    """The generic kernels' template flags: bit 0 adaptive, bit 1 offset
    (OMSA/AOMSA), bits 2-3 the check update (``check_flags``: 4 SPA, 8
    SPA-lin). The fused kernel's launch adds its ``SLICE`` flag where its
    plan puts the checks in global memory."""
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return (int(algorithm.is_adaptive) | (int(offset) << 1)
            | (check_flags(algorithm) << 2))


def edge_offsets(groups, count: int) -> np.ndarray:
    """[count + 1] edge offsets of the nodes of one side's degree groups."""
    deg = np.zeros(count, dtype=np.int64)
    for g in groups:
        deg[g.node_start:g.node_start + g.count] = g.degree
    return np.concatenate([[0], np.cumsum(deg)])


def to_slot_major(groups, values) -> np.ndarray:
    """[E] one side's edge values from node-major order within each degree
    group ([count, degree]) to slot-major ([degree, count])."""
    out = np.empty_like(values)
    for g in groups:
        size = g.count * g.degree
        block = values[g.edge_offset:g.edge_offset + size]
        out[g.edge_offset:g.edge_offset + size] = \
            block.reshape(g.count, g.degree).T.reshape(-1)
    return out


def generic_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                  matrix: HMatrix, algorithm: DecodingAlgorithm,
                  max_iterations: int, use_threshold: bool) -> Callable:
    """``kernel_trial`` of a generic kernel, with the generic plain version:
    the f32 generic torch decoder, ``calculate_syndrome`` and the key
    compare."""
    plain = make_trial(layout_for(matrix), algorithm, max_iterations,
                       use_threshold, torch.float32)
    return kernel_trial(kernel, counts, plan_for, matrix,
                        generic_flags(algorithm), matrix.num_bit_nodes,
                        max_iterations, use_threshold, plain)


def generic_montecarlo(kernel: str, counts: KernelCounts, plan_for: Callable,
                       matrix: HMatrix, algorithm: DecodingAlgorithm,
                       max_iterations: int, use_threshold: bool) -> Callable:
    """``kernel_montecarlo`` of a generic kernel, with the generic plain
    trial."""
    plain = make_trial(layout_for(matrix), algorithm, max_iterations,
                       use_threshold, torch.float32)
    return kernel_montecarlo(kernel, counts, plan_for, matrix,
                             generic_flags(algorithm), matrix.num_bit_nodes,
                             max_iterations, use_threshold, plain)


def generic_decoder(kernel: str, counts: KernelCounts, plan_for: Callable,
                    matrix: HMatrix, algorithm: DecodingAlgorithm,
                    max_iterations: int,
                    use_threshold: bool) -> Callable[..., DecodeResult]:
    """``kernel_decoder`` of a generic kernel, with the f32 generic torch
    decoder as its plain version."""
    plain = get_decoder(layout_for(matrix), algorithm, max_iterations,
                        use_threshold, torch.float32)
    return kernel_decoder(kernel, counts, plan_for, matrix,
                          generic_flags(algorithm), matrix.num_bit_nodes,
                          matrix.num_check_nodes, max_iterations,
                          use_threshold, plain)
