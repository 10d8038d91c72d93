"""Fused QC decoder: wrappers of the hand-written CUDA kernel and their plain
torch versions.

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
any other device raises. There is no fallback from a failed launch. The
wrapper body is ``launch.qc_trial`` / ``qc_montecarlo`` /
``qc_frame_trial`` / ``qc_decoder``, shared with the streamed QC kernel
(``ops/qc_stream.py``); this module gives it the fused kernel's launch
plan.

``launch_plan(qc, flags, mode)`` is the kernel's launch shape, computed
here so that the CPU tests reach it (a mirror of the kernel's shared
layout, held to the library's by a card test): threads and frames per
block, shared bytes per block, and where the SPA pair's messages live.
``fused_qc_fits(qc, layered)`` says, without building anything, whether the
kernel holds a code: Z, the block-edge count and the base rows within its
limits, and one frame's totals, compressed min-sum messages, key bits and
the mc selection within a block's shared memory. Codes beyond it run on
the streamed QC kernel; ``engines.qc_kernel`` makes that choice.

Counters: as ``counts.KernelCounts`` (``launches``, ``mc_launches``,
``plain_calls``, ``plain_on_cuda``); ``reset_counts`` zeroes them and
``counts`` reads ``(launches, plain_on_cuda)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.counts import (
    KernelCounts,
    stream_of,
)
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu_torch.ops.launch import (
    MAX_SHARED_BYTES,
    MODES,
    align16,
    block_edge_table,
    cached_plans,
    kernel_flags,
    limit_reason,
    pointers,
    qc_decoder,
    qc_frame_trial,
    qc_montecarlo,
    qc_trial,
    shape_of,
)
from qkd_ldpc_v_tpu_torch.ops.philox import SELECTION_BYTES
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import base_tables


COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The kernel's limits (csrc/fused_qc.cu: kMaxZ, kMaxBlockEdges,
# kMaxBaseChecks; a card test holds them equal to the library's).
MAX_LIFTING = 1024
MAX_BLOCK_EDGES = 256
MAX_BASE_CHECKS = 64
# The kernel's launch flag for the SPA pair's messages in global memory
# (csrc/fused_qc.cu: kSpaGlobal).
SPA_GLOBAL = 32
# Edges of a check the kernel keeps in registers (csrc/fused_qc.cu: kRun);
# its address table pads each block-row to this many slots.
RUN = 16

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
    size = align16(24 * num_be + 8 * RUN * mb + 4 * (mb + 1) + 4 * (nb + 1))
    size = align16(size + 4 * n)
    if not spa:
        msgs = 8 * m + 4 * ((2 * max_deg + 31) // 32) * m
    else:
        msgs = 0 if spa_global else 4 * num_be * z
    if mode == "mc":
        msgs = max(msgs, SELECTION_BYTES)
    size = align16(size + msgs)
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


class _Launch:
    """Launch plan of one code, kernel variant and device: the kernel's
    table on the device and, per mode, the ``LaunchPlan`` and, where the SPA
    pair's messages are in global memory, the blocks that fit on the card
    at once. ``messages`` forces where the SPA pair's messages live (tests
    only). ``launch`` launches one mode."""

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
                    resident = kernels.library().fused_qc_resident_blocks(
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

    def launch(self, mode: str, batch: int, inputs, scalars, outs) -> int:
        """Launch the kernel's entry of ``mode`` on ``batch`` frames and
        return its CUDA error code (``inputs``, ``scalars`` and ``outs``:
        see ``launch.kernel_trial``). Where the SPA pair's messages are in
        global memory, the launch adds the flag and a slice per resident
        block; the slice is freed once the launch is queued, and the caching
        allocator reuses it only in stream order."""
        plan = self.plans[mode]
        tail, ext = (None, batch), None
        if plan.messages == "global":
            blocks = min(batch, self.resident[mode])
            ext = torch.empty(blocks * plan.slice_floats, dtype=torch.float32,
                              device=outs[0].device)
            scalars = (scalars[0] | SPA_GLOBAL,) + tuple(scalars[1:])
            tail = (ext.data_ptr(), blocks)
        return getattr(kernels.library(), f"fused_qc_{mode}")(
            *inputs, *self.shape, *scalars, *tail, *pointers(*outs),
            stream_of(outs[0]))


_launch_plan = cached_plans(_Launch)


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
