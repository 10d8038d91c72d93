"""Streamed QC decoder: wrappers of the hand-written CUDA kernel for QC codes
whose per-frame state does not fit in one block's shared memory, and their
plain torch versions.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_qc_stream.py``
(``make_pallas_qc_stream_trial``, ``make_pallas_qc_stream_montecarlo`` and
``make_pallas_qc_stream_decoder``; the kernel is ``csrc/qc_stream.cu``), for
the min-sum family NMSA, OMSA, ANMSA and AOMSA on the flooding and layered
schedules, and the SPA pair (SPA, SPA-lin-approx) on the flooding schedule:

  * ``make_qc_stream_trial`` — the Monte-Carlo trial of given keys for the
    N=102400 QC codes: Alice's and Bob's keys in, per-frame
    ``(syndromes_match, keys_match, iterations)`` out;
  * ``make_qc_stream_montecarlo`` — the Monte-Carlo sweep's hot path: a
    seed in, the keys drawn in the kernel (``ops/philox.py``), the same
    statistics out;
  * ``make_qc_stream_decoder`` — the library decode: LLRs and a syndrome
    in, a ``DecodeResult`` out.

Both have the signatures and returns of ``ops/fused_qc.py``'s wrappers, and
the same plain versions (``ops/qc_decoder.py``: ``decode_flooding`` and
``decode_layered``), so the two kernels give identical results wherever
both run. Routing is by the tensors' device and nothing else: CPU tensors
go to the plain version, CUDA tensors launch the kernel (or raise beyond
its limits), and any other device raises. There is no fallback from a
failed launch.

The kernel's own limits are ``MAX_LIFTING``, ``MAX_BLOCK_EDGES``,
``MAX_BASE_CHECKS``, ``MAX_BASE_BITS`` and one frame within the shared
memory of a cluster of 16 CTAs, which admits every shape the JAX package's
``qc_stream`` gate admits (N up to about 786k; the gate, a TPU VMEM budget
that says nothing about this kernel, is ``engines.qc_stream_feasible``).

``plan_for`` is the launch plan of one mode, computed here so that the CPU
tests reach it: the smallest thread-block cluster (1, 2, 4, 8 or 16 CTAs)
whose per-CTA share of a frame fits in 227 KB, the threads and shared
bytes per CTA, and the scratch words per cluster (the compressed min-sum
checks, or the SPA pair's extrinsics). ``compress_row`` and
``rebuild_row`` mirror the kernel's compressed check in torch, for tests.

The wrapper body (checks, device routing, outputs, counting) is
``launch.qc_trial`` / ``qc_montecarlo`` / ``qc_decoder``, shared with the
fused QC kernel; this module gives it the streamed kernel's launch plan.

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
    align16,
    block_edge_table,
    cached_plans,
    limit_reason,
    pointers,
    qc_decoder,
    qc_montecarlo,
    qc_trial,
    shape_of,
)
from qkd_ldpc_v_tpu_torch.ops.philox import SELECTION_BYTES
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import _RowUpdate, base_tables

COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The kernel's limits (csrc/qc_stream.cu: kMaxLifting, kMaxBlockEdges,
# kMaxBaseChecks, kMaxBaseBits; a card test holds them equal to the
# library's).
MAX_LIFTING = 32768
MAX_BLOCK_EDGES = 1024
MAX_BASE_CHECKS = 1024
MAX_BASE_BITS = 8191

# The cluster sizes the kernel launches with, smallest first
# (csrc/qc_stream.cu: kMaxCluster); one CTA holds ``MAX_SHARED_BYTES``.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# The kernel's modes (csrc/qc_stream.cu: Mode), by which its shared layout,
# cluster size and resident clusters differ.
_MODES = {"decode": 0, "trial": 1, "mc": 2}


@dataclass(frozen=True)
class Plan:
    """One mode's launch shape: CTAs per cluster, threads and shared bytes
    per CTA, and scratch words per cluster (csrc/qc_stream.cu's
    ``threads_for``, ``shared_layout`` and ``scratch_words``; a card test
    holds them equal to the library's)."""

    cluster: int
    threads: int
    shared_bytes: int
    scratch_words: int


def threads_for(z: int, cluster: int) -> int:
    return min(1024, (-(-z // cluster) + 31) // 32 * 32)


def shared_bytes(mb: int, nb: int, z: int, num_be: int, cluster: int,
                 mode: str) -> int:
    """One CTA's shared bytes: the table (``stream_table`` and one word
    more per block edge: the kernel keeps two totals addresses and the
    shift and split in one word, where the caller's table has cols and
    shifts), the cluster votes, the mc selection, each thread's syndrome
    words, the share of the f32 totals and (trial, mc) of Alice's and
    Bob's packed bits."""
    threads = threads_for(z, cluster)
    share = (-(-nb * z // cluster) + 31) // 32 * 32
    per_row = -(-z // (cluster * threads))
    syn_words = (mb * per_row + 31) // 32
    size = align16(4 * (mb + 1 + 4 * num_be + (nb + 2) // 2))
    size += align16(4 * 2 * 16)
    if mode == "mc":
        size += align16(SELECTION_BYTES)
    size += align16(4 * threads * syn_words)
    size += 4 * share
    if mode != "decode":
        size += 2 * (share // 8)
    return size


def scratch_words(mb: int, z: int, num_be: int, max_deg: int,
                  spa: bool) -> int:
    """One cluster's global words: per check its two stored values and
    the words of its edge bits (min-sum), or f32 extrinsics (the SPA
    pair)."""
    m = mb * z
    words = num_be * z if spa else (2 + (2 * max_deg + 31) // 32) * m
    return (words + 31) // 32 * 32


def plan_for_shape(mb: int, nb: int, z: int, num_be: int, max_deg: int,
                   mode: str, spa: bool,
                   cluster: Optional[int] = None) -> Optional[Plan]:
    """The smallest cluster whose per-CTA share fits (or ``cluster``, where
    it fits), or None. A cluster has at most ``nb`` CTAs, so that a base
    column spans at most two CTAs' shares."""
    for c in CLUSTER_SIZES if cluster is None else (cluster,):
        if c > nb:
            break
        size = shared_bytes(mb, nb, z, num_be, c, mode)
        if size <= MAX_SHARED_BYTES:
            return Plan(c, threads_for(z, c), size,
                        scratch_words(mb, z, num_be, max_deg, spa))
    return None


def plan_for(qc: QCMatrix, mode: str, spa: bool = False,
             cluster: Optional[int] = None) -> Plan:
    """The launch plan of one mode; raises ``NotImplementedError`` beyond
    the kernel's limits (``_check_limits``)."""
    _check_limits(qc)
    plan = plan_for_shape(*shape_of(qc), mode, spa, cluster)
    if plan is None:
        raise NotImplementedError(
            f"streamed QC kernel: cluster of {cluster} CTAs cannot hold the "
            f"frame in {mode} mode")
    return plan


def _check_limits(qc: QCMatrix) -> None:
    reason = limit_reason(qc, MAX_LIFTING, MAX_BLOCK_EDGES, MAX_BASE_CHECKS)
    if reason is None and qc.base_bits > MAX_BASE_BITS:
        reason = f"base bits = {qc.base_bits} exceeds {MAX_BASE_BITS}"
    if reason is None and plan_for_shape(*shape_of(qc), "mc", False) is None:
        reason = (f"one frame (N = {qc.num_bit_nodes}) exceeds the shared "
                  f"memory of {CLUSTER_SIZES[-1]} CTAs")
    if reason is not None:
        raise NotImplementedError(f"streamed QC kernel: {reason}")


def stream_table(qc: QCMatrix) -> List[int]:
    """The kernel's table: the QC kernels' block-edge table (row_ptr,
    cols, shifts), then, per column in base-row order, its edges as ``row |
    edge << 10 | slot << 20`` (slot: the edge's index in its row), then
    col_ptr[nb+1] as 16-bit halves, two to an int."""
    rows, cols, _ = base_tables(qc)
    where = {e: (r, k) for r, row in enumerate(rows)
             for k, (e, _, _) in enumerate(row)}
    col_ptr, col_edges = [0], []
    for col in cols:
        col_edges += [where[e][0] | (e << 10) | (where[e][1] << 20)
                      for (e, _, _) in col]
        col_ptr.append(len(col_edges))
    col_ptr.append(0)
    halves = [col_ptr[i] | (col_ptr[i + 1] << 16)
              for i in range(0, 2 * ((qc.base_bits + 2) // 2), 2)]
    return block_edge_table(qc) + col_edges + halves


class _Launch:
    """Launch plan of one code, kernel variant and device: the table on the
    device and, per mode, the ``Plan`` and the clusters that fit on the
    card at once. ``cluster`` forces the CTAs per cluster (tests only).
    ``launch`` launches one mode. A refused launch or no resident cluster
    raises; there is no other path."""

    def __init__(self, qc: QCMatrix, flags: int, device: torch.device,
                 cluster: Optional[int] = None):
        mb, nb, z, num_be, max_deg = shape_of(qc)
        spa = bool(flags >> 3)
        self.plans = {mode: plan_for(qc, mode, spa, cluster)
                      for mode in _MODES}
        self.resident = {}
        for mode, code in _MODES.items():
            with torch.cuda.device(device):
                resident = kernels.library().qc_stream_resident_clusters(
                    mb, nb, z, num_be, flags, code, self.plans[mode].cluster)
            if resident <= 0:
                raise RuntimeError(
                    f"streamed QC kernel: no cluster of "
                    f"{self.plans[mode].cluster} CTAs fits on {device} "
                    f"(CUDA error {-resident})")
            self.resident[mode] = resident
        self.table = torch.tensor(stream_table(qc), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), mb, nb, z, num_be, max_deg)

    def launch(self, mode: str, batch: int, inputs, scalars, outs) -> int:
        """Launch the kernel's entry of ``mode`` on ``batch`` frames over as
        many clusters as fit at once, with their global scratch, and return
        its CUDA error code (``inputs``, ``scalars`` and ``outs``: see
        ``launch.kernel_trial``). The scratch is freed once the launch is
        queued; the caching allocator reuses it only in stream order."""
        plan = self.plans[mode]
        clusters = min(batch, self.resident[mode])
        scratch = torch.empty(clusters * plan.scratch_words,
                              dtype=torch.int32, device=outs[0].device)
        return getattr(kernels.library(), f"qc_stream_{mode}")(
            *inputs, *self.shape, *scalars, scratch.data_ptr(),
            plan.scratch_words, plan.cluster, clusters * plan.cluster,
            *pointers(*outs), stream_of(outs[0]))


_launch_plan = cached_plans(_Launch)


def make_qc_stream_trial(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable:
    """Streamed Monte-Carlo trial.

    ``trial(alice [B,N] int8, bob [B,N] int8, log_p, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``, with ``log_p`` the float32 channel-LLR
    magnitude ``log((1-q)/q)`` from ``channel.log_ratio``. ``trial.plain``
    is the plain torch version with the same signature.
    """
    return qc_trial("streamed QC", COUNTS, _launch_plan, qc, algorithm,
                    max_iterations, use_threshold, schedule)


def make_qc_stream_montecarlo(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable:
    """Streamed Monte-Carlo trials with keys drawn in the kernel (the
    counterpart of ``make_pallas_qc_stream_montecarlo``): ``mc(seed, frame0,
    batch, num_errors, log_p, primary, secondary, threshold, device="cuda")
    -> (syndromes_match, keys_match, iterations)``, as
    ``fused_qc.make_fused_qc_montecarlo``, whose results it equals.
    ``mc.plain`` is ``channel.mc_channel`` followed by the plain trial.
    """
    return qc_montecarlo("streamed QC", COUNTS, _launch_plan, qc, algorithm,
                         max_iterations, use_threshold, schedule)


def make_qc_stream_decoder(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    schedule: str = "flooding",
) -> Callable[..., DecodeResult]:
    """Streamed decode: ``decode(llr [B,N] f32, syndrome [B,M] int8, primary,
    secondary, threshold) -> DecodeResult``. ``decode.plain`` is the plain
    torch version with the same signature."""
    return qc_decoder("streamed QC", COUNTS, _launch_plan, qc, algorithm,
                      max_iterations, use_threshold, schedule)


def compress_row(upd: _RowUpdate, msgs: List[torch.Tensor],
                 syn_bits: torch.Tensor, second: torch.Tensor):
    """The kernel's compressed form of one block-row's min-sum check
    messages (plain mirror, used by tests): from the bit->check messages,
    the syndrome bits and where the secondary factor applies, ``(p1, p2,
    edge_bits)`` per check: the clamped check->bit values of an edge whose
    message is positive with ``|m| != min1`` and with ``|m| == min1``, and
    per edge bit 0 ``m > 0`` and bit 1 ``|m| == min1`` (int32 tensors)."""
    a = [m.abs() for m in msgs]
    min1 = a[0]
    min2 = torch.full_like(min1, float(upd.big))
    for ai in a[1:]:
        min2 = torch.minimum(min2, torch.maximum(min1, ai))
        min1 = torch.minimum(min1, ai)
    neg = torch.zeros(min1.shape, dtype=torch.int32, device=min1.device)
    for m in msgs:
        neg = neg + (m < 0).to(torch.int32)
    one = torch.ones_like(min1)
    ss = torch.where(syn_bits == 1, -one, one)
    row_sign = ss * torch.where(neg % 2 == 0, one, -one)
    f = torch.where(second, upd.secondary, upd.primary)
    p1, p2 = (upd.clamp(row_sign * one * torch.maximum(eabs - f, upd.zero))
              if upd.offset else upd.clamp(f * row_sign * one * eabs)
              for eabs in (min1, min2))
    bits = [(m > 0).to(torch.int32) | ((ai == min1).to(torch.int32) << 1)
            for m, ai in zip(msgs, a)]
    return p1, p2, bits


def rebuild_row(upd: _RowUpdate, p1: torch.Tensor, p2: torch.Tensor,
                bits: List[torch.Tensor]):
    """The check->bit values that ``compress_row``'s form stands for, as
    the kernel rebuilds them (``stored_value``): p2 where ``|m| == min1``,
    else p1, negated where ``m <= 0`` unless the clamp's threshold is
    negative (every clamped value is then the threshold). Equal, bit for
    bit, to ``_RowUpdate.__call__`` on the messages it was made from."""
    neg_same = upd.use_threshold and float(upd.threshold) < 0.0
    vals = []
    for b in bits:
        v = torch.where(b & 2 != 0, p2, p1)
        vals.append(v if neg_same else torch.where(b & 1 != 0, v, -v))
    return vals
