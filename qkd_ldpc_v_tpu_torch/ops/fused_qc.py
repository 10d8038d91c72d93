"""Fused QC decoder: wrappers of the hand-written CUDA kernel and their plain
torch versions, and the wrapper body both QC kernels share.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_qc.py`` (``make_pallas_qc_trial``,
``make_pallas_qc_frame_trial`` and ``make_pallas_qc_decoder``; the kernel is
``csrc/fused_qc.cu``):

  * ``make_fused_qc_trial`` — the Monte-Carlo sweep's hot path: Alice's and
    Bob's keys in; Alice's syndrome, the channel LLRs, the decode and the
    key comparison all happen in the kernel, which returns per-frame
    ``(syndromes_match, keys_match, iterations)``.
  * ``make_fused_qc_frame_trial`` — the rate-adaptive sweep's step: Alice's
    rate-adapted frame and its LLRs in (``channel.build_frames``); Alice's
    syndrome, the decode and the key comparison happen in the kernel, which
    returns the same per-frame statistics.
  * ``make_fused_qc_decoder`` — the library decode: LLRs and a syndrome in,
    a ``DecodeResult`` out.

Routing is by the tensors' device and nothing else: CPU tensors go to the
plain version (``ops/qc_decoder.py``), CUDA tensors launch the kernel, and
any other device raises. There is no fallback from a failed launch.
``kernel_trial``, ``kernel_frame_trial`` and ``kernel_decoder`` hold that
wrapper body once for every kernel of the package; ``qc_trial`` and
``qc_decoder`` give it the QC plain versions, and the streamed QC kernel
(``ops/qc_stream.py``) uses them with its own launch plan.

``fused_qc_fits(qc, layered)`` says, without building anything, whether the
kernel holds a code: Z, the block-edge count and the base rows within its
limits, and one frame's totals (and, flooding, its channel LLRs) within a
block's shared memory. Codes beyond it run on the streamed QC kernel;
``simulation.qc_kernel`` makes that choice.

Counters: ``COUNTS.launches`` counts kernel launches;
``COUNTS.plain_on_cuda`` counts plain-version calls on CUDA tensors, which
only tests and the card smoke's comparisons make. ``reset_counts`` zeroes
both and ``counts`` reads them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.channel import qc_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult, frame_trial
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import (
    base_tables,
    check_algorithm,
    decode_flooding,
    decode_layered,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache


class KernelCounts:
    """One kernel's counters: launches of the kernel, and calls of its plain
    version on CUDA tensors."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain_on_cuda = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_on_cuda = 0

    def get(self) -> Tuple[int, int]:
        """(kernel launches, plain-version calls on CUDA tensors)."""
        return self.launches, self.plain_on_cuda

    def count_plain(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            self.plain_on_cuda += 1


COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# Shared memory one block may use on sm_90 (227 KB).
MAX_SHARED_BYTES = 232448
# The kernel's limits (csrc/fused_qc.cu: kMaxZ, kMaxBlockEdges,
# kMaxBaseChecks; a card test holds them equal to the library's).
MAX_LIFTING = 1024
MAX_BLOCK_EDGES = 256
MAX_BASE_CHECKS = 64

_TABLES = PlanCache()
_SIGNATURES_SET = False


def check_schedule(schedule: str) -> bool:
    """True for layered; raises on an unknown schedule."""
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return schedule == "layered"


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
    check_algorithm(algorithm)

    def decode(llr, syndrome, primary, secondary, threshold):
        return plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                            use_threshold, layered, primary, secondary,
                            threshold)

    return frame_trial(decode, lambda alice: qc_syndrome(qc, alice))


def kernel_flags(algorithm: DecodingAlgorithm, layered: bool) -> int:
    """The QC kernels' template flags: bit 0 layered, bit 1 adaptive, bit 2
    offset (OMSA/AOMSA)."""
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return int(layered) | (int(algorithm.is_adaptive) << 1) | (int(offset) << 2)


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


def _lib() -> ctypes.CDLL:
    global _SIGNATURES_SET
    lib = kernels.library()
    if not _SIGNATURES_SET:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_qc_trial.argtypes = [
            p, p, i, p, i, i, i, i, i, i, i, f, f, f, f, p, p, p, p]
        lib.fused_qc_trial.restype = i
        lib.fused_qc_decode.argtypes = [
            p, p, i, p, i, i, i, i, i, i, i, f, f, f, p, p, p, p]
        lib.fused_qc_decode.restype = i
        lib.fused_qc_frame.argtypes = lib.fused_qc_decode.argtypes
        lib.fused_qc_frame.restype = i
        for name in ("fused_qc_max_lifting", "fused_qc_max_block_edges",
                     "fused_qc_max_base_checks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        _SIGNATURES_SET = True
    return lib


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


def _unfit_reason(qc: QCMatrix, layered: bool) -> Optional[str]:
    """Why the fused kernel cannot hold this code, or None where it can."""
    reason = limit_reason(qc, MAX_LIFTING, MAX_BLOCK_EDGES, MAX_BASE_CHECKS)
    if reason is not None:
        return reason
    shared = 4 * (qc.base_checks + 1 + 2 * len(qc.block_edges)) + \
        (1 if layered else 2) * 4 * qc.num_bit_nodes
    if shared > MAX_SHARED_BYTES:
        return (f"{shared} bytes of shared memory per frame exceed "
                f"{MAX_SHARED_BYTES}")
    return None


def fused_qc_fits(qc: QCMatrix, layered: bool) -> bool:
    """Whether the fused kernel holds this code (its limits above and one
    frame's totals in shared memory). Pure Python: routing needs no build."""
    return _unfit_reason(qc, layered) is None


def pointers(*tensors: torch.Tensor) -> List[int]:
    return [t.data_ptr() for t in tensors]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cached_plans(make: Callable) -> Callable:
    """``plan_for(code, flags, device)``: ``make(code, flags, device)``,
    built once per code (by identity), flags and device."""
    plans = PlanCache()

    def plan_for(code, flags: int, device):
        key = (flags, str(device))
        plan = plans.get(code, extra=key)
        if plan is None:
            plan = make(code, flags, device)
            plans.put(code, plan, extra=key)
        return plan

    return plan_for


class _Launch:
    """Launch plan of one code on one device: the block-edge table
    (row_ptr[mb+1], cols[num_be], shifts[num_be] int32, storage order).
    ``trial``, ``frame`` and ``decode`` launch the kernel and return its
    CUDA error code (arguments: see ``kernel_trial``,
    ``kernel_frame_trial`` and ``kernel_decoder``)."""

    def __init__(self, qc: QCMatrix, layered: bool, device: torch.device):
        reason = _unfit_reason(qc, layered)
        if reason is not None:
            raise NotImplementedError(
                f"fused QC kernel: {reason}; larger codes need the streamed "
                "QC kernel (ops/qc_stream.py)"
            )
        self.table = torch.tensor(block_edge_table(qc), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), qc.base_checks, qc.base_bits,
                      qc.lifting, len(qc.block_edges))

    def trial(self, alice, bob, scalars, outs) -> int:
        return _lib().fused_qc_trial(
            *pointers(alice, bob), alice.shape[0], *self.shape, *scalars,
            *pointers(*outs), stream_of(alice))

    def frame(self, alice, llr, scalars, outs) -> int:
        return _lib().fused_qc_frame(
            *pointers(alice, llr), alice.shape[0], *self.shape, *scalars,
            *pointers(*outs), stream_of(alice))

    def decode(self, llr, syndrome, scalars, outs) -> int:
        return _lib().fused_qc_decode(
            *pointers(llr, syndrome), llr.shape[0], *self.shape, *scalars,
            *pointers(*outs), stream_of(llr))


def _launch_plan(qc: QCMatrix, flags: int, device) -> _Launch:
    layered = bool(flags & 1)
    key = (layered, str(device))
    plan = _TABLES.get(qc, extra=key)
    if plan is None:
        plan = _Launch(qc, layered, device)
        _TABLES.put(qc, plan, extra=key)
    return plan


def check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def _stats_wrapper(kernel: str, what: str, counts: KernelCounts,
                   plan_for: Callable, code, flags: int, n: int,
                   max_iterations: int, use_threshold: bool,
                   second: Tuple[str, torch.dtype], plain: Callable) -> Tuple[
                       Callable, Callable]:
    """The body of the wrappers that return per-frame statistics: checks,
    routing by device, outputs and counting. ``call(alice, other,
    scalars)`` takes Alice's keys or frame [B, n] int8, the second input
    ``second = (name, dtype)`` [B, n] and the call's float scalars, and
    launches the plan's method ``what``; ``counted_plain(alice, other,
    *scalars)`` runs ``plain`` and counts it."""

    def counted_plain(alice, other, *scalars):
        counts.count_plain(alice)
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
        conv = torch.empty(b, dtype=torch.int8, device=alice.device)
        keys = torch.empty(b, dtype=torch.int8, device=alice.device)
        iters = torch.empty(b, dtype=torch.int32, device=alice.device)
        if b == 0:
            return conv.bool(), keys.bool(), iters
        launch_scalars = (flags, int(use_threshold), int(max_iterations),
                          *(float(x) for x in scalars))
        raise_on_error(getattr(plan, what)(alice, other, launch_scalars,
                                           (conv, keys, iters)),
                       f"{kernel} {what}")
        counts.launches += 1
        return conv.bool(), keys.bool(), iters

    return call, counted_plain


def kernel_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                 code, flags: int, n: int, max_iterations: int,
                 use_threshold: bool, plain: Callable) -> Callable:
    """The trial wrapper body every kernel of this package shares: checks,
    routing by device, outputs and counting, for the kernel named
    ``kernel``, counted in ``counts``, on ``code`` with ``n`` bits.
    ``plan_for(code, flags, device)`` gives its launch plan, whose
    ``trial(alice, bob, scalars, outs)`` launches it with ``scalars =
    (flags, use_threshold, max_iterations, log_p, primary, secondary,
    threshold)`` and ``outs = (conv, keys, iters)`` and returns the CUDA
    error code. ``plain`` is the plain version, with the trial's
    signature."""
    call, counted_plain = _stats_wrapper(
        kernel, "trial", counts, plan_for, code, flags, n, max_iterations,
        use_threshold, ("bob", torch.int8), plain)

    def trial(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        return call(alice, bob, (log_p, primary, secondary, threshold))

    trial.plain = counted_plain
    return trial


def kernel_frame_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                       code, flags: int, n: int, max_iterations: int,
                       use_threshold: bool, plain: Callable) -> Callable:
    """The frame-trial wrapper body, as ``kernel_trial``: the plan's
    ``frame(alice_frame, llr, scalars, outs)`` launches the kernel's frame
    mode with ``scalars = (flags, use_threshold, max_iterations, primary,
    secondary, threshold)``; ``plain(alice_frame, llr, primary, secondary,
    threshold)`` returns ``(conv, keys, iters)``."""
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
    ``decode(llr, syndrome, scalars, outs)`` takes ``scalars = (flags,
    use_threshold, max_iterations, primary, secondary, threshold)`` and
    ``outs = (decisions, conv, iters)``; ``plain(llr, syndrome, primary,
    secondary, threshold)`` returns a ``DecodeResult``."""

    def counted_plain(llr, syndrome, primary=1.0, secondary=1.0,
                      threshold=0.0):
        counts.count_plain(llr)
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
        scalars = (flags, int(use_threshold), int(max_iterations),
                   float(primary), float(secondary), float(threshold))
        raise_on_error(plan.decode(llr, syndrome, scalars, (dec, conv, iters)),
                       f"{kernel} decode")
        counts.launches += 1
        return DecodeResult(dec, conv.bool(), iters)

    decode.plain = counted_plain
    return decode


def qc_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
             qc: QCMatrix, algorithm: DecodingAlgorithm, max_iterations: int,
             use_threshold: bool, schedule: str) -> Callable:
    """``kernel_trial`` of a QC kernel, with the QC plain version
    (``ops/qc_decoder.py``) in the schedule asked for."""
    layered = check_schedule(schedule)
    tail = _plain_frame_trial(qc, algorithm, max_iterations, use_threshold,
                              layered)

    def plain(alice, bob, log_p, primary, secondary, threshold):
        lp = torch.tensor(log_p, dtype=torch.float32, device=alice.device)
        return tail(alice, torch.where(bob == 1, -lp, lp), primary, secondary,
                    threshold)

    return kernel_trial(kernel, counts, plan_for, qc,
                        kernel_flags(algorithm, layered), qc.num_bit_nodes,
                        max_iterations, use_threshold, plain)


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
    check_algorithm(algorithm)
    layered = check_schedule(schedule)

    def plain(llr, syndrome, primary, secondary, threshold):
        return plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                            use_threshold, layered, primary, secondary,
                            threshold)

    return kernel_decoder(kernel, counts, plan_for, qc,
                          kernel_flags(algorithm, layered), qc.num_bit_nodes,
                          qc.num_check_nodes, max_iterations, use_threshold,
                          plain)


def make_fused_qc_trial(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable:
    """Fused Monte-Carlo trial.

    ``trial(alice [B,N] int8, bob [B,N] int8, log_p, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``, with ``log_p`` the float32 channel-LLR
    magnitude ``log((1-q)/q)`` from ``channel.log_ratio``. ``trial.plain``
    is the plain torch version with the same signature.
    """
    return qc_trial("fused QC", COUNTS, _launch_plan, qc, algorithm,
                    max_iterations, use_threshold, schedule)


def make_fused_qc_frame_trial(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable:
    """Fused trial of prebuilt rate-adapted frames.

    ``trial(alice_frame [B,N] int8, llr [B,N] f32, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``: the kernel forms Alice's syndrome from her
    frame, decodes the LLRs and compares the decisions with her frame.
    ``trial.plain`` is the plain torch version with the same signature.
    """
    return qc_frame_trial("fused QC", COUNTS, _launch_plan, qc, algorithm,
                          max_iterations, use_threshold, schedule)


def make_fused_qc_decoder(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable[..., DecodeResult]:
    """Fused decode: ``decode(llr [B,N] f32, syndrome [B,M] int8, primary,
    secondary, threshold) -> DecodeResult``. ``decode.plain`` is the plain
    torch version with the same signature."""
    return qc_decoder("fused QC", COUNTS, _launch_plan, qc, algorithm,
                      max_iterations, use_threshold, schedule)
