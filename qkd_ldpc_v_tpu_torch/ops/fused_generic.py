"""Fused generic decoder: wrappers of the hand-written CUDA kernel for
arbitrary sparse parity-check matrices, and their plain torch versions.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_generic.py``
(``make_pallas_generic_trial``, ``make_pallas_generic_montecarlo``,
``make_pallas_generic_frame_trial`` and ``make_pallas_generic_decoder``; the
kernel is ``csrc/fused_generic.cu``), for the six algorithms (the min-sum
family NMSA, OMSA, ANMSA and AOMSA, and the SPA pair SPA and
SPA-lin-approx) on the flooding schedule:

  * ``make_fused_generic_trial`` — the Monte-Carlo trial of given keys for
    alist / format-1 / format-2 / dense codes: Alice's and Bob's keys in;
    Alice's syndrome, the channel LLRs, the decode and the key comparison
    all happen in the kernel, which returns per-frame ``(syndromes_match,
    keys_match, iterations)``.
  * ``make_fused_generic_montecarlo`` — the Monte-Carlo sweep's hot path: a
    seed in, the keys drawn in the kernel. Each bit draws its keys at its
    external position, so the port's three mc kernels share one channel
    (``channel.mc_channel``). This departs on purpose from the TPU kernel,
    which draws over its flat, lane-padded node planes: its hardware
    generator's bits cannot be matched anyway.
  * ``make_fused_generic_frame_trial`` — the rate-adaptive sweep's step:
    Alice's rate-adapted frame and its LLRs in; Alice's syndrome, the decode
    and the key comparison in the kernel.
  * ``make_fused_generic_decoder`` — the library decode: LLRs and a
    syndrome in, a ``DecodeResult`` out.

The plain version is the generic torch decoder (``ops/decoders.py``) in
float32 plus ``calculate_syndrome`` and the key comparison; the kernel
equals it exactly (decisions, convergence, iterations).

Routing is by the tensors' device and nothing else: CPU tensors go to the
plain version, CUDA tensors launch the kernel, and any other device
raises. There is no fallback from a failed launch. The wrapper body is
``launch.generic_trial`` / ``generic_montecarlo`` / ``generic_decoder``,
shared with the streamed generic kernel (``ops/generic_stream.py``), and
``launch.kernel_frame_trial`` with the generic plain version; this module
gives it the fused kernel's launch plan.

``generic_feasible(matrix)`` is this port's gate for the ``generic``
engine. It picks exactly the codes that the JAX package's
``generic_plan_feasible`` picks: its edge space in the TPU kernel's
degree-grouped 128-lane plane layout needs at most ``MAX_TILES``
128 x 128 tiles (about N = 32k at bit degree 2). The kernel serves every
code inside it whose totals and key bits fit a block's shared memory.

``launch_plan(matrix, flags, mode)`` is the kernel's launch shape, computed
here so that the CPU tests reach it (a mirror of the kernel's shared
layout, held to the library's by a card test): threads and shared bytes
per block, and where a frame's checks live (min-sum: compressed, 12 bytes
a check of degree <= 16; the SPA pair: an f32 per slot) — in shared memory
where one frame fits a block's, else in a per-block global slice.
``fused_tables`` builds the kernel's index tables from the layout, and
``compress_check`` / ``rebuild_check`` mirror its compressed min-sum check
for the tests.

Counters: as ``counts.KernelCounts`` (``launches``, ``mc_launches``,
``plain_calls``, ``plain_on_cuda``); ``reset_counts`` zeroes them and
``counts`` reads ``(launches, plain_on_cuda)``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout, layout_for
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu_torch.ops.counts import (
    KernelCounts,
    stream_of,
)
from qkd_ldpc_v_tpu_torch.ops.decoders import (
    DecodeResult,
    frame_trial,
    get_decoder,
)
from qkd_ldpc_v_tpu_torch.ops.launch import (
    MAX_SHARED_BYTES,
    MODES,
    align16,
    cached_plans,
    edge_offsets,
    generic_decoder,
    generic_flags,
    generic_montecarlo,
    generic_trial,
    kernel_frame_trial,
    pointers,
    to_slot_major,
)
from qkd_ldpc_v_tpu_torch.ops.philox import SELECTION_BYTES

COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The JAX package's gate (pallas_generic.py: MAX_TILES tiles of LANES x
# LANES edge rows), copied as a predicate.
MAX_TILES = 4
LANES = 128

# Threads per block (a warp multiple; csrc/fused_generic.cu takes 32 to
# kMaxThreads = 1024 at up to 64 registers a thread): 512 where two
# blocks' shared memory fits on an SM, else 1024 (one block). At the 10k
# alist code's 16384-frame mc chunk (NVIDIA H100 80GB HBM3, 700 W;
# scripts/probe_fused_generic.py) min-sum (78 KB a block) took 25.6 ms at
# 512 threads against 28.5 at 1024 and 30.0 at 256, and SPA-lin (214 KB)
# 34.5 ms at 1024 against 54.5 at 512 and 93.0 at 256.
THREADS = (512, 1024)
# Shared memory of one SM on sm_90 (228 KB), of which each block reserves
# 1 KB.
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
# The kernel's launch flag for the checks in a per-block global slice
# (csrc/fused_generic.cu: kSlice).
SLICE = 16
# Edges of a check the kernel keeps in registers (csrc/fused_generic.cu:
# kRun); the check table is padded with this many entries.
RUN = 16


def _edge_rows(rows: List[np.ndarray]) -> int:
    """Edge-plane rows of one side in the TPU kernel's layout: each degree
    class d of `count` nodes takes d * ceil(count / LANES) rows
    (pallas_generic.py::_node_side)."""
    degrees = np.array([len(r) for r in rows], dtype=np.int64)
    classes, counts_ = np.unique(degrees, return_counts=True)
    return int(sum(int(d) * -(-int(c) // LANES)
                   for d, c in zip(classes, counts_)))


def generic_feasible(matrix: HMatrix) -> bool:
    """Whether the ``generic`` engine serves this code: the same verdict as
    the JAX package's ``generic_plan_feasible``."""
    if matrix.num_edges > MAX_TILES * LANES * LANES:
        return False
    used = max(_edge_rows(matrix.bit_nodes), _edge_rows(matrix.check_nodes))
    return -(-used // LANES) <= MAX_TILES


def bit_entries(layout: EdgeLayout) -> np.ndarray:
    """[E] the bit-major edge words in the layout's bit-major order (each
    bit's edges in slot order, ascending check index): the edge's internal
    check c and its slot s in that check's row, as ``c | s << 16``."""
    cptr = edge_offsets(layout.check_groups, layout.num_checks)
    check_of = np.repeat(np.arange(layout.num_checks), np.diff(cptr))
    pos = np.asarray(layout.to_bit_major, dtype=np.int64)
    c = check_of[pos]
    return c | ((pos - cptr[c]) << 16)


def _rows(groups, count: int, slot_major: bool) -> np.ndarray:
    """[count, 4] each node's Row in its table: (offset of its slot 0,
    stride, degree, 0); node-major: the node's edge offset and stride 1,
    slot-major: its group's offset plus its index there and the group's
    node count."""
    rows = np.zeros((count, 4), dtype=np.int64)
    for g in groups:
        j = np.arange(g.count)
        node = g.node_start + j
        if slot_major:
            rows[node, 0], rows[node, 1] = g.edge_offset + j, g.count
        else:
            rows[node, 0], rows[node, 1] = g.edge_offset + j * g.degree, 1
        rows[node, 2] = g.degree
    return rows


def fused_tables(layout: EdgeLayout, slot_major: bool) -> np.ndarray:
    """The fused kernel's index tables, concatenated as int32 (see
    csrc/fused_generic.cu): the checks' Rows [M][4] (slot k of internal
    check c at ``row[0] + k * row[1]``, ``row[2]`` slots), the bits' Rows
    [N][4], the internal bit of each check edge [E] padded with ``RUN``
    zeros (a register run may read past the last check), and each bit
    edge's ``c | s << 16`` word [E] (``bit_entries``), both node-major
    (min-sum) or slot-major within their degree groups (``slot_major``: the
    SPA pair), then bit_ext[N] (external index of each internal bit),
    chk_ext[M] (of each internal check) and ext_bit[N] (the internal index
    of each external bit, bit_ext's inverse)."""
    cbit = np.asarray(layout.check_edge_bit, dtype=np.int64)
    bent = bit_entries(layout)
    if slot_major:
        cbit = to_slot_major(layout.check_groups, cbit)
        bent = to_slot_major(layout.bit_groups, bent)
    parts = [
        _rows(layout.check_groups, layout.num_checks, slot_major).reshape(-1),
        _rows(layout.bit_groups, layout.num_bits, slot_major).reshape(-1),
        cbit,
        np.zeros(RUN, dtype=np.int64),
        bent,
        layout.bit_order,
        layout.check_order,
        layout.bit_inv,
    ]
    return np.concatenate([np.asarray(x, dtype=np.int64) for x in parts]
                          ).astype(np.int32)


def compress_check(msgs: List[torch.Tensor], syn_bits: torch.Tensor,
                   factor: torch.Tensor, offset: bool, use_threshold: bool,
                   threshold: float):
    """The kernel's compressed form of a check's min-sum check->bit values
    (plain mirror of ``csrc/fused_generic.cu::minsum_run``, used by tests):
    from the bit->check messages in slot order (one tensor of checks per
    slot), the syndrome bits and each check's factor, ``(p1, p2,
    edge_bits)``: the clamped values of an edge whose message is positive
    with ``|m| != min1`` and with ``|m| == min1``, and per edge bit 0
    ``m > 0`` and bit 1 ``|m| == min1`` (int32). The second minimum follows
    the generic decoder's tie rule: inf where every ``|m|`` of a check of two
    or more edges is inf."""
    a = [m.abs() for m in msgs]
    min1 = a[0]
    min2 = torch.full_like(min1, float(np.finfo(np.float32).max))
    for ai in a[1:]:
        min2 = torch.minimum(min2, torch.maximum(min1, ai))
        min1 = torch.minimum(min1, ai)
    if len(msgs) >= 2:
        min2 = torch.where(torch.isinf(min1), min1, min2)
    neg = torch.zeros(min1.shape, dtype=torch.int32)
    for m in msgs:
        neg = neg ^ (m < 0).to(torch.int32)
    one = torch.ones_like(min1)
    row_sign = (torch.where(syn_bits == 1, -one, one)
                * torch.where(neg == 0, one, -one))
    bound = threshold if use_threshold else float("inf")

    def value(eabs):
        v = (row_sign * one * torch.maximum(eabs - factor,
                                            torch.zeros_like(eabs))
             if offset else factor * row_sign * one * eabs)
        return torch.minimum(torch.maximum(v, -one * bound), one * bound)

    bits = [(m > 0).to(torch.int32) | ((ai == min1).to(torch.int32) << 1)
            for m, ai in zip(msgs, a)]
    return value(min1), value(min2), bits


def rebuild_check(p1: torch.Tensor, p2: torch.Tensor,
                  bits: List[torch.Tensor], neg_same: bool):
    """The check->bit values that ``compress_check``'s form stands for, as
    the kernel rebuilds them (``stored_value``): p2 where ``|m| == min1``,
    else p1, negated where ``m <= 0`` unless the clamp's threshold is
    negative (``neg_same``: every clamped value is then the threshold)."""
    vals = []
    for b in bits:
        v = torch.where(b & 2 != 0, p2, p1)
        vals.append(v if neg_same else torch.where(b & 1 != 0, v, -v))
    return vals


@dataclass(frozen=True)
class LaunchPlan:
    """One mode's launch shape (csrc/fused_generic.cu's ``shared_layout``
    and ``slice_floats``; a card test holds them equal to the library's):
    threads and shared bytes per block, and where the checks live:
    ``"shared"``, one frame per block and one block per frame, or
    ``"global"``, a per-block slice of ``slice_floats`` floats (a frame's
    checks rounded up to 16 bytes) in global memory walked by a persistent
    grid of as many blocks as fit at once."""

    threads: int
    shared_bytes: int
    checks: str
    slice_floats: int


def code_shape(layout: EdgeLayout) -> Tuple[int, int, int, int]:
    """(N, M, E, largest check degree)."""
    max_deg = max((g.degree for g in layout.check_groups), default=0)
    return layout.num_bits, layout.num_checks, layout.num_edges, max_deg


def check_floats(m: int, max_deg: int, spa: bool) -> int:
    """Floats of one frame's checks: min-sum 8 bytes of value pair and 2
    bits per edge, in words, per check; the SPA pair one f32 per slot of
    the largest degree, per check."""
    if spa:
        return max_deg * m
    return (2 + (2 * max_deg + 31) // 32) * m


def shared_bytes(n: int, m: int, max_deg: int, spa: bool, slice_: bool,
                 mode: str) -> int:
    """One block's shared bytes: the f32 totals; the checks unless they are
    in the global slice (the mc mode's staging holds the selection state,
    then Alice's bits in external order, in this space); the syndrome bits,
    Alice's bits (all modes but decode) and Bob's (trial, mc), packed."""
    bits = 4 * (-(-n // 32))
    msgs = 0 if slice_ else 4 * check_floats(m, max_deg, spa)
    if mode == "mc":
        msgs = max(msgs, align16(SELECTION_BYTES) + bits)
    size = align16(align16(4 * n) + msgs) + 4 * (-(-m // 32))
    if mode != "decode":
        size += bits
    if mode in ("trial", "mc"):
        size += bits
    return size


def launch_plan(matrix: HMatrix, flags: int, mode: str,
                checks: Optional[str] = None,
                threads: Optional[int] = None) -> LaunchPlan:
    """The launch plan of one mode and template ``flags``
    (``launch.generic_flags``): the checks in shared memory where one frame
    fits a block's, else in global memory; ``THREADS[0]`` threads where two
    blocks fit an SM's shared memory, else ``THREADS[1]`` (``checks`` and
    ``threads`` force either, for tests and probes). Raises
    ``NotImplementedError`` where even the totals and key bits exceed a
    block's shared memory."""
    n, m, _, max_deg = code_shape(layout_for(matrix))
    spa = bool((flags >> 2) & 3)
    if checks is None:
        checks = "shared"
        if shared_bytes(n, m, max_deg, spa, False, mode) > MAX_SHARED_BYTES:
            checks = "global"
    if checks not in ("shared", "global"):
        raise ValueError(f"checks = {checks!r}: 'shared' or 'global'")
    glob = checks == "global"
    size = shared_bytes(n, m, max_deg, spa, glob, mode)
    if size > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"fused generic kernel: {size} bytes of shared memory per block "
            f"exceed {MAX_SHARED_BYTES} (N={n}, M={m})")
    if threads is None:
        two = 2 * (size + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
        threads = THREADS[0] if two else THREADS[1]
    return LaunchPlan(threads, size, checks,
                      -(-check_floats(m, max_deg, spa) // 4) * 4 if glob
                      else 0)


class _Launch:
    """Launch plan of one code, algorithm family and device: the index
    tables on the device and, per mode, the ``LaunchPlan`` and the blocks
    that fit on one SM (``per_sm``) and on the card (``resident``) at once.
    ``checks`` and ``threads`` force the plan (tests and probes only).
    ``launch`` launches one mode."""

    def __init__(self, matrix: HMatrix, flags: int, device: torch.device,
                 checks: Optional[str] = None,
                 threads: Optional[int] = None):
        layout = layout_for(matrix)
        n, m, e, max_deg = code_shape(layout)
        if not generic_feasible(matrix):
            raise NotImplementedError(
                f"fused generic kernel: the code (N={n}, E={e}) is outside "
                "the generic engine's gate; larger codes need the streamed "
                "generic kernel (ops/generic_stream.py)"
            )
        self.plans = {mode: launch_plan(matrix, flags, mode, checks, threads)
                      for mode in MODES}
        self.per_sm, self.resident = {}, {}
        for mode, plan in self.plans.items():
            launch_flags = flags | (SLICE if plan.checks == "global" else 0)
            per_sm = ctypes.c_int(0)
            with torch.cuda.device(device):
                resident = kernels.library().fused_generic_resident_blocks(
                    n, m, e, max_deg, launch_flags, MODES[mode],
                    plan.threads, ctypes.byref(per_sm))
            if resident <= 0:
                raise RuntimeError(
                    f"fused generic kernel: no block fits on {device} (CUDA "
                    f"error {-resident})")
            self.per_sm[mode], self.resident[mode] = per_sm.value, resident
        self.table = torch.tensor(
            fused_tables(layout, slot_major=bool((flags >> 2) & 3)),
            dtype=torch.int32, device=device)
        self.shape = (self.table.data_ptr(), n, m, e, max_deg)

    def launch(self, mode: str, batch: int, inputs, scalars, outs) -> int:
        """Launch the kernel's entry of ``mode`` on ``batch`` frames and
        return its CUDA error code (``inputs``, ``scalars`` and ``outs``:
        see ``launch.kernel_trial``). Where the plan puts the checks in
        global memory, the launch adds ``SLICE`` and a slice per resident
        block; the slice is freed once the launch is queued, and the caching
        allocator reuses it only in stream order."""
        plan = self.plans[mode]
        tail, ext = (None, batch, plan.threads), None
        if plan.checks == "global":
            blocks = min(batch, self.resident[mode])
            ext = torch.empty(blocks * plan.slice_floats, dtype=torch.float32,
                              device=outs[0].device)
            scalars = (scalars[0] | SLICE,) + tuple(scalars[1:])
            tail = (ext.data_ptr(), blocks, plan.threads)
        return getattr(kernels.library(), f"fused_generic_{mode}")(
            *inputs, *self.shape, *scalars, *tail, *pointers(*outs),
            stream_of(outs[0]))


_launch_plan = cached_plans(_Launch)


def make_fused_generic_trial(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable:
    """Fused Monte-Carlo trial.

    ``trial(alice [B,N] int8, bob [B,N] int8, log_p, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``, with ``log_p`` the float32 channel-LLR
    magnitude from ``channel.log_ratio`` (the JAX trial takes the QBER and
    forms it inside its jit). ``trial.plain`` is the plain torch version
    with the same signature.
    """
    return generic_trial("fused generic", COUNTS, _launch_plan, matrix,
                         algorithm, max_iterations, use_threshold)


def make_fused_generic_montecarlo(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable:
    """Fused Monte-Carlo trials with keys drawn in the kernel (the
    counterpart of ``make_pallas_generic_montecarlo``): ``mc(seed, frame0,
    batch, num_errors, log_p, primary, secondary, threshold, device="cuda")
    -> (syndromes_match, keys_match, iterations)``, as
    ``fused_qc.make_fused_qc_montecarlo``. ``mc.plain`` is
    ``channel.mc_channel`` followed by the plain trial.
    """
    return generic_montecarlo("fused generic", COUNTS, _launch_plan, matrix,
                              algorithm, max_iterations, use_threshold)


def make_fused_generic_frame_trial(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable:
    """Fused trial of prebuilt rate-adapted frames.

    ``trial(alice_frame [B,N] int8, llr [B,N] f32, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``. The plain version is Alice's syndrome
    (``calculate_syndrome``), the f32 generic torch decoder and the key
    compare over the whole frame; ``trial.plain`` runs it.
    """
    layout = layout_for(matrix)
    decode = get_decoder(layout, algorithm, max_iterations, use_threshold,
                         torch.float32)

    plain = frame_trial(decode, lambda alice_frame: calculate_syndrome(
        layout, alice_frame))
    return kernel_frame_trial("fused generic", COUNTS, _launch_plan, matrix,
                              generic_flags(algorithm), matrix.num_bit_nodes,
                              max_iterations, use_threshold, plain)


def make_fused_generic_decoder(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable[..., DecodeResult]:
    """Fused decode: ``decode(llr [B,N] f32, syndrome [B,M] int8, primary,
    secondary, threshold) -> DecodeResult``. ``decode.plain`` is the plain
    torch version with the same signature."""
    return generic_decoder("fused generic", COUNTS, _launch_plan, matrix,
                           algorithm, max_iterations, use_threshold)
