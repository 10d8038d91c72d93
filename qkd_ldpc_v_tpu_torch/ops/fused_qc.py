"""Fused QC decoder: wrappers of the hand-written CUDA kernel and their plain
torch versions, and the wrapper body both QC kernels share.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_qc.py`` (``make_pallas_qc_trial``,
``make_pallas_qc_montecarlo``, ``make_pallas_qc_frame_trial`` and
``make_pallas_qc_decoder``; the kernel is ``csrc/fused_qc.cu``):

  * ``make_fused_qc_trial`` — the Monte-Carlo trial of given keys: Alice's
    and Bob's keys in; Alice's syndrome, the channel LLRs, the decode and
    the key comparison all happen in the kernel, which returns per-frame
    ``(syndromes_match, keys_match, iterations)``.
  * ``make_fused_qc_montecarlo`` — the Monte-Carlo sweep's hot path: a seed
    in; the kernel also draws the keys (``ops/philox.py``), so nothing of
    size [B, N] touches device memory. Its plain version is
    ``channel.mc_channel`` followed by the plain trial.
  * ``make_fused_qc_frame_trial`` — the rate-adaptive sweep's step: Alice's
    rate-adapted frame and its LLRs in (``channel.build_frames``); Alice's
    syndrome, the decode and the key comparison happen in the kernel, which
    returns the same per-frame statistics.
  * ``make_fused_qc_decoder`` — the library decode: LLRs and a syndrome in,
    a ``DecodeResult`` out.

Routing is by the tensors' device and nothing else: CPU tensors go to the
plain version (``ops/qc_decoder.py``), CUDA tensors launch the kernel, and
any other device raises. There is no fallback from a failed launch.
``kernel_trial``, ``kernel_montecarlo``, ``kernel_frame_trial`` and
``kernel_decoder`` hold that wrapper body once for every kernel of the
package; ``qc_trial``, ``qc_montecarlo`` and ``qc_decoder`` give it the QC
plain versions, and the streamed QC kernel (``ops/qc_stream.py``) uses them
with its own launch plan.

``launch_plan(qc, flags, mode)`` is the kernel's launch shape, computed
here so that the CPU tests reach it (a mirror of the kernel's shared
layout, held to the library's by a card test): threads and frames per
block, shared bytes per block, and where the SPA pair's messages live.
``fused_qc_fits(qc, layered)`` says, without building anything, whether the
kernel holds a code: Z, the block-edge count and the base rows within its
limits, and one frame's totals, compressed min-sum messages, key bits and
the mc selection within a block's shared memory. Codes beyond it run on
the streamed QC kernel; ``simulation.qc_kernel`` makes that choice.

Counters: ``COUNTS.launches`` counts kernel launches in the trial, frame
and decode modes and ``COUNTS.mc_launches`` those in the mc mode;
``COUNTS.plain_calls`` counts plain-version calls by device type and mode,
``COUNTS.plain_on_cuda`` those on CUDA tensors (which only tests and the
card smoke's comparisons make) and ``COUNTS.plain(mode)`` those of one
mode. ``reset_counts`` zeroes them and ``counts`` reads ``(launches,
plain_on_cuda)``.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.channel import mc_channel, qc_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult, frame_trial
from qkd_ldpc_v_tpu_torch.ops.philox import key_of
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import (
    SPA_PAIR,
    base_tables,
    check_layered,
    decode_flooding,
    decode_layered,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache, span


class KernelCounts:
    """One kernel's counters: launches of the kernel in the trial, frame and
    decode modes (``launches``) and in the mc mode (``mc_launches``), and
    calls of its plain version keyed by ``(device type, mode)``
    (``plain_calls``), from which ``plain_on_cuda`` and ``plain`` read."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.mc_launches = 0
        self.plain_calls = Counter()

    @property
    def plain_on_cuda(self) -> int:
        """Plain-version calls on CUDA tensors."""
        return sum(n for (device, _), n in self.plain_calls.items()
                   if device == "cuda")

    def plain(self, mode: str) -> int:
        """Plain-version calls of ``mode`` on any device."""
        return sum(n for (_, m), n in self.plain_calls.items() if m == mode)

    def get(self) -> Tuple[int, int]:
        """(kernel launches outside the mc mode, plain-version calls on CUDA
        tensors)."""
        return self.launches, self.plain_on_cuda

    def count_launch(self, mode: str) -> None:
        if mode == "mc":
            self.mc_launches += 1
        else:
            self.launches += 1

    def count_plain(self, device: torch.device, mode: str) -> None:
        self.plain_calls[device.type, mode] += 1


COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The trace names of the kernel families, by the name the wrappers give
# their kernel: each launch and each plain-version call that a
# ``KernelCounts`` counts is the span ``kernel.<family>.<mode>``.
SPAN_FAMILIES = {"fused QC": "fused_qc", "streamed QC": "qc_stream",
                 "fused generic": "fused_generic",
                 "streamed generic": "generic_stream"}


def kernel_span(kernel: str, mode: str) -> str:
    """The span name of ``kernel``'s launches and plain calls in ``mode``."""
    return f"kernel.{SPAN_FAMILIES[kernel]}.{mode}"


# Shared memory one block may use on sm_90 (227 KB).
MAX_SHARED_BYTES = 232448
# The kernel's limits (csrc/fused_qc.cu: kMaxZ, kMaxBlockEdges,
# kMaxBaseChecks; a card test holds them equal to the library's).
MAX_LIFTING = 1024
MAX_BLOCK_EDGES = 256
MAX_BASE_CHECKS = 64
# Shared memory of the mc mode's selection state (csrc/philox.cuh::Selection:
# 256 bins, 512 listed keys, five words; a card test holds it equal to the
# library's).
SELECTION_BYTES = 4 * (256 + 512 + 5)
# The kernel's modes (csrc/fused_qc.cu: Mode), by which its shared layout
# differs, and its launch flag for the SPA pair's messages in global memory
# (kSpaGlobal).
MODES = {"decode": 0, "trial": 1, "frame": 2, "mc": 3}
SPA_GLOBAL = 32
# Edges of a check the kernel keeps in registers (csrc/fused_qc.cu: kRun);
# its address table pads each block-row to this many slots.
RUN = 16

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

    def decode(llr, syndrome, primary, secondary, threshold):
        return plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                            use_threshold, layered, primary, secondary,
                            threshold)

    return frame_trial(decode, lambda alice: qc_syndrome(qc, alice))


def check_flags(algorithm: DecodingAlgorithm) -> int:
    """The check update's template flag of every kernel of this package: 0
    min-sum, 1 SPA, 2 SPA-lin-approx (csrc/spa.cuh: kMinSum, kSpa,
    kSpaLin)."""
    return SPA_PAIR.index(algorithm) + 1 if algorithm in SPA_PAIR else 0


def kernel_flags(algorithm: DecodingAlgorithm, layered: bool) -> int:
    """The QC kernels' template flags: bit 0 layered, bit 1 adaptive, bit 2
    offset (OMSA/AOMSA), bits 3-4 the check update (``check_flags``: 8 SPA,
    16 SPA-lin). Raises ``ValueError`` for the layered schedule with the SPA
    pair, which floods, before any launch."""
    check_layered(algorithm, layered)
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return (int(layered) | (int(algorithm.is_adaptive) << 1)
            | (int(offset) << 2) | (check_flags(algorithm) << 3))


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


def fused_table(qc: QCMatrix) -> List[int]:
    """The fused kernel's table: the block-edge table, then, per column in
    base-row order, its edges as ``edge | row << 8 | slot << 16`` (slot: the
    edge's index in its row), then col_ptr[nb+1]."""
    rows, cols, _ = base_tables(qc)
    where = {e: (r, k) for r, row in enumerate(rows)
             for k, (e, _, _) in enumerate(row)}
    col_ptr, col_edges = [0], []
    for col in cols:
        col_edges += [e | (where[e][0] << 8) | (where[e][1] << 16)
                      for (e, _, _) in col]
        col_ptr.append(len(col_edges))
    return block_edge_table(qc) + col_edges + col_ptr


@dataclass(frozen=True)
class LaunchPlan:
    """One mode's launch shape (csrc/fused_qc.cu's ``threads_for`` and
    ``shared_layout``; a card test holds them equal to the library's):
    threads and frames per block, shared bytes per block, and where the
    SPA pair's messages live: ``"shared"``, or ``"global"``, a per-block
    slice of ``slice_floats`` floats in global memory, in which case a
    persistent grid of as many blocks as fit at once walks the frames."""

    threads: int
    frames_per_block: int
    shared_bytes: int
    messages: str
    slice_floats: int


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def shape_of(qc: QCMatrix) -> Tuple[int, int, int, int, int]:
    """(mb, nb, Z, block edges, largest row degree)."""
    rows, _, num_be = base_tables(qc)
    return (qc.base_checks, qc.base_bits, qc.lifting, num_be,
            max((len(r) for r in rows), default=0))


def shared_bytes(mb: int, nb: int, z: int, num_be: int, max_deg: int,
                 spa: bool, spa_global: bool, mode: str) -> int:
    """One block's shared bytes: per block edge its column entry (16 bytes)
    and its address pair (8), the address pairs again by row padded to
    ``RUN`` slots, row_ptr and col_ptr; the f32 totals; the messages
    (min-sum: 8 bytes of value pair and 2 bits per edge, in words, per
    check; the SPA pair in shared memory: f32 per edge; the mc mode's
    selection state shares this space); Alice's bits (all modes but
    decode) and Bob's (trial, mc), packed."""
    n, m = nb * z, mb * z
    size = _align16(24 * num_be + 8 * RUN * mb + 4 * (mb + 1) + 4 * (nb + 1))
    size = _align16(size + 4 * n)
    if not spa:
        msgs = 8 * m + 4 * ((2 * max_deg + 31) // 32) * m
    else:
        msgs = 0 if spa_global else 4 * num_be * z
    if mode == "mc":
        msgs = max(msgs, SELECTION_BYTES)
    size = _align16(size + msgs)
    bits = 4 * ((n + 31) // 32)
    if mode != "decode":
        size += bits
    if mode in ("trial", "mc"):
        size += bits
    return size


def launch_plan(qc: QCMatrix, flags: int, mode: str,
                messages: Optional[str] = None) -> LaunchPlan:
    """The launch plan of one mode and template ``flags`` (``kernel_flags``):
    a block of Z threads rounded up to a warp multiple per frame; the SPA
    pair's messages in shared memory where a frame's fit, else in global
    memory (``messages`` forces either, for tests)."""
    mb, nb, z, num_be, max_deg = shape_of(qc)
    spa = bool((flags >> 3) & 3)
    if messages is None:
        messages = "shared"
        if spa and shared_bytes(mb, nb, z, num_be, max_deg, True, False,
                                mode) > MAX_SHARED_BYTES:
            messages = "global"
    if messages not in ("shared", "global") or (messages == "global"
                                                and not spa):
        raise ValueError(f"messages = {messages!r}: the SPA pair's messages "
                         "are 'shared' or 'global', min-sum's 'shared'")
    glob = messages == "global"
    return LaunchPlan((z + 31) // 32 * 32, 1,
                      shared_bytes(mb, nb, z, num_be, max_deg, spa, glob,
                                   mode),
                      messages, num_be * z if glob else 0)


def _lib() -> ctypes.CDLL:
    global _SIGNATURES_SET
    lib = kernels.library()
    if not _SIGNATURES_SET:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        ll = ctypes.c_longlong
        shape = [p, i, i, i, i, i]  # table, mb, nb, z, num_be, max_deg
        tail = [p, i]               # slice, grid
        lib.fused_qc_trial.argtypes = [
            p, p, i, *shape, i, i, i, f, f, f, f, *tail, p, p, p, p]
        lib.fused_qc_trial.restype = i
        lib.fused_qc_decode.argtypes = [
            p, p, i, *shape, i, i, i, f, f, f, *tail, p, p, p, p]
        lib.fused_qc_decode.restype = i
        lib.fused_qc_frame.argtypes = lib.fused_qc_decode.argtypes
        lib.fused_qc_frame.restype = i
        lib.fused_qc_mc.argtypes = [
            u, u, i, i, i, *shape, i, i, i, f, f, f, f, *tail, p, p, p, p]
        lib.fused_qc_mc.restype = i
        lib.fused_qc_threads.argtypes = [i]
        lib.fused_qc_threads.restype = i
        lib.fused_qc_shared_bytes.argtypes = [i, i, i, i, i, i, i]
        lib.fused_qc_shared_bytes.restype = ll
        lib.fused_qc_resident_blocks.argtypes = [i, i, i, i, i, i, i]
        lib.fused_qc_resident_blocks.restype = i
        for name in ("fused_qc_max_lifting", "fused_qc_max_block_edges",
                     "fused_qc_max_base_checks", "mc_selection_bytes"):
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
    """Why the fused kernel cannot hold this code, or None where it can.
    Both schedules keep the same layout; the min-sum mc mode's is the
    largest (the SPA pair's messages go to global memory where they do not
    fit)."""
    reason = limit_reason(qc, MAX_LIFTING, MAX_BLOCK_EDGES, MAX_BASE_CHECKS)
    if reason is not None:
        return reason
    shared = launch_plan(qc, kernel_flags(DecodingAlgorithm.NMSA, layered),
                         "mc").shared_bytes
    if shared > MAX_SHARED_BYTES:
        return (f"{shared} bytes of shared memory per frame exceed "
                f"{MAX_SHARED_BYTES}")
    return None


def fused_qc_fits(qc: QCMatrix, layered: bool) -> bool:
    """Whether the fused kernel holds this code in every mode (its limits
    above, and one frame's totals, compressed messages, key bits and the mc
    mode's selection state in shared memory). Pure Python: routing needs no
    build."""
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
            with span("kernel.plan"):
                plan = make(code, flags, device)
            plans.put(code, plan, extra=key)
        return plan

    return plan_for


class _Launch:
    """Launch plan of one code, kernel variant and device: the kernel's
    table on the device and, per mode, the ``LaunchPlan`` and, where the SPA
    pair's messages are in global memory, the blocks that fit on the card
    at once. ``messages`` forces where the SPA pair's messages live (tests
    only). ``trial``, ``mc``, ``frame`` and ``decode`` launch the kernel and
    return its CUDA error code (arguments: see ``kernel_trial``,
    ``kernel_montecarlo``, ``kernel_frame_trial`` and ``kernel_decoder``)."""

    def __init__(self, qc: QCMatrix, flags: int, device: torch.device,
                 messages: Optional[str] = None):
        reason = _unfit_reason(qc, bool(flags & 1))
        if reason is not None:
            raise NotImplementedError(
                f"fused QC kernel: {reason}; larger codes need the streamed "
                "QC kernel (ops/qc_stream.py)"
            )
        self.plans = {mode: launch_plan(qc, flags, mode, messages)
                      for mode in MODES}
        mb, nb, z, num_be, max_deg = shape_of(qc)
        self.resident = {}
        for mode, plan in self.plans.items():
            if plan.messages == "global":
                with torch.cuda.device(device):
                    resident = _lib().fused_qc_resident_blocks(
                        mb, nb, z, num_be, max_deg, flags | SPA_GLOBAL,
                        MODES[mode])
                if resident <= 0:
                    raise RuntimeError(
                        f"fused QC kernel: no block fits on {device} (CUDA "
                        f"error {-resident})")
                self.resident[mode] = resident
        self.table = torch.tensor(fused_table(qc), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), mb, nb, z, num_be, max_deg)

    def _launch(self, mode: str, batch: int, scalars, device):
        """(scalars with the plan's flags, (slice, grid), the slice tensor)
        of one launch. The slice is freed once the launch is queued; the
        caching allocator reuses it only in stream order."""
        plan = self.plans[mode]
        if plan.messages == "shared":
            return scalars, (None, batch), None
        blocks = min(batch, self.resident[mode])
        ext = torch.empty(blocks * plan.slice_floats, dtype=torch.float32,
                          device=device)
        return ((scalars[0] | SPA_GLOBAL,) + tuple(scalars[1:]),
                (ext.data_ptr(), blocks), ext)

    def trial(self, alice, bob, scalars, outs) -> int:
        scalars, tail, _keep = self._launch("trial", alice.shape[0], scalars,
                                            alice.device)
        return _lib().fused_qc_trial(
            *pointers(alice, bob), alice.shape[0], *self.shape, *scalars,
            *tail, *pointers(*outs), stream_of(alice))

    def mc(self, draw, scalars, outs) -> int:
        scalars, tail, _keep = self._launch("mc", draw[-1], scalars,
                                            outs[0].device)
        return _lib().fused_qc_mc(
            *draw, *self.shape, *scalars, *tail, *pointers(*outs),
            stream_of(outs[0]))

    def frame(self, alice, llr, scalars, outs) -> int:
        scalars, tail, _keep = self._launch("frame", alice.shape[0], scalars,
                                            alice.device)
        return _lib().fused_qc_frame(
            *pointers(alice, llr), alice.shape[0], *self.shape, *scalars,
            *tail, *pointers(*outs), stream_of(alice))

    def decode(self, llr, syndrome, scalars, outs) -> int:
        scalars, tail, _keep = self._launch("decode", llr.shape[0], scalars,
                                            llr.device)
        return _lib().fused_qc_decode(
            *pointers(llr, syndrome), llr.shape[0], *self.shape, *scalars,
            *tail, *pointers(*outs), stream_of(llr))


_launch_plan = cached_plans(_Launch)


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
    and launches the plan's method ``what``; ``counted_plain(alice, other,
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
        return _launch_stats(
            kernel, what, name, counts, alice.device, b,
            lambda outs: getattr(plan, what)(alice, other, launch_scalars,
                                             outs))

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


def kernel_montecarlo(kernel: str, counts: KernelCounts, plan_for: Callable,
                      code, flags: int, n: int, max_iterations: int,
                      use_threshold: bool, plain: Callable) -> Callable:
    """The mc wrapper body, as ``kernel_trial``: ``mc(seed, frame0, batch,
    num_errors, log_p, primary, secondary, threshold, device="cuda")``
    decodes frames ``frame0 .. frame0 + batch - 1`` of the chunk whose seed
    is ``seed`` (``channel.chunk_seed``) with keys drawn from its Philox
    stream, ``num_errors`` errors each, and returns ``(syndromes_match,
    keys_match, iterations)`` on ``device``. The plan's ``mc(draw, scalars,
    outs)`` launches the kernel's mc mode with ``draw = (k0, k1, frame0,
    num_errors, batch)`` and the trial's ``scalars``. ``mc.plain`` is
    ``channel.mc_channel`` followed by ``plain``, the plain trial; a CPU
    ``device`` runs it, CUDA launches the kernel, and any other device
    raises. Both record the span ``kernel_span(kernel, "mc")``."""
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
        return _launch_stats(kernel, "mc", name, counts, device, batch,
                             lambda outs: plan.mc(draw, scalars, outs))

    mc.plain = counted_plain
    return mc


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
    secondary, threshold)`` returns a ``DecodeResult``. Both record the
    span ``kernel_span(kernel, "decode")``."""
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
            raise_on_error(plan.decode(llr, syndrome, scalars,
                                       (dec, conv, iters)), f"{kernel} decode")
            counts.count_launch("decode")
        return DecodeResult(dec, conv.bool(), iters)

    decode.plain = counted_plain
    return decode


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


def make_fused_qc_montecarlo(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable:
    """Fused Monte-Carlo trials with keys drawn in the kernel (the
    counterpart of ``make_pallas_qc_montecarlo``).

    ``mc(seed, frame0, batch, num_errors, log_p, primary, secondary,
    threshold, device="cuda") -> (syndromes_match [B] bool, keys_match [B]
    bool, iterations [B] int32)``: frames ``frame0 .. frame0 + batch - 1``
    of the chunk whose seed is ``seed``, each with Alice's key and exactly
    ``num_errors`` errors from ``channel.mc_channel``'s stream. ``mc.plain``
    is ``mc_channel`` followed by the plain trial.
    """
    return qc_montecarlo("fused QC", COUNTS, _launch_plan, qc, algorithm,
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
