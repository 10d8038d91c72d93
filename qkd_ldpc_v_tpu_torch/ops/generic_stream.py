"""Streamed generic decoder: wrappers of the hand-written CUDA kernels for
arbitrary sparse codes whose per-frame state does not fit in one block's
shared memory, and their plain torch versions.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_stream.py``
(``make_pallas_stream_trial`` and ``make_pallas_stream_decoder``; the
kernels are ``csrc/generic_cluster.cu`` and ``csrc/generic_stream.cu``,
which replace that module's four kernels and its while-loop), for the six
algorithms (the min-sum family NMSA, OMSA, ANMSA and AOMSA, and the SPA
pair) on the flooding schedule:

  * ``make_generic_stream_trial`` — the Monte-Carlo sweep's hot path for
    the N=102400 alist code: Alice's and Bob's keys in, per-frame
    ``(syndromes_match, keys_match, iterations)`` out;
  * ``make_generic_stream_decoder`` — the library decode: LLRs and a
    syndrome in, a ``DecodeResult`` out.

Both have the signatures and returns of ``ops/fused_generic.py``'s
wrappers and the same plain versions (the f32 generic torch decoder plus
``calculate_syndrome`` and the key compare), so the two generic kernels
give identical results wherever both run. The wrapper body is
``launch.generic_trial`` / ``generic_decoder``; this module gives it the
streamed kernel's launch plan. Routing is by the tensors' device and
nothing else: CPU tensors go to the plain version, CUDA tensors launch the
kernel (or raise), and any other device raises. There is no fallback from
a failed launch.

Two kernels, routed by what a launch decodes and the code's shape alone
(``cluster_plan``; the plan is built once per code and cached). Trial mode
of the min-sum family takes the cluster kernel (``csrc/generic_cluster.cu``)
wherever a cluster of 1-16 CTAs holds a frame's totals and key bits and
every check has at most ``MAX_DEGREE`` edges: a thread-block cluster
decodes a group of F frames at a time (8 in 16 CTAs at the N=102400 alist
code, 4 in one CTA at the 10k one), their totals in distributed shared
memory, their min-sum checks compressed to one 16-byte record a check and
frame in an L2-resident slice, groups taken from an atomic counter. Decode
mode (an f32 LLR plane more), the SPA pair (no two-minimum form), codes
beyond those limits and launches that pin ``group`` take the batch-minor
kernel (``csrc/generic_stream.cu``). ``cluster_tables`` builds the cluster
kernel's tables and ``launch_tables`` the batch-minor kernel's.

The batch-minor kernel decodes a group of F frames per block with
batch-minor messages (``[E, F]`` f32 per block in a global scratch) and
bit-packed node planes (one bit per frame), in shared memory where they
fit. The library carries
``GROUPS`` = (8, 16); a launch takes the wider group where its groups
still fill the resident grid and the narrower one below that
(``group_for``; PERF.md has the times that chose the rule), unless the
caller pins one. ``launch_shape`` gives a launch's group count, grid and
scratch bytes, ``shared_bytes`` a block's shared memory, and
``check_shared_memory`` raises, naming N and M, before any launch of a code
whose planes exceed it (at F=8, N + M > 227 KB, e.g. N=200k at rate 0.7);
F=16 serves the codes whose 2N bytes of decisions fit.

The kernel serves any code within its shared memory, inside the JAX
package's ``stream`` gate (``engines.stream_feasible``) or not
(``tpu.force_engine = "stream"`` sends a code inside the generic gate here
too). The JAX sweep's two-phase straggler re-decode for this
engine (``tpu.phase1_iterations``) is not ported: a group iterates to its
slowest frame, but a frame that has converged makes no more loads or
stores, and the measured waste does not call for it (PERF.md).

Counters: ``COUNTS.launches`` counts kernel launches of either kernel;
``COUNTS.cluster_launches`` and ``COUNTS.cluster_frames`` the launches and
frames that took the cluster kernel; ``COUNTS.plain_on_cuda`` counts
plain-version calls on CUDA tensors, which only tests and the card smoke's
comparisons make. ``reset_counts`` zeroes them and ``counts`` reads
``(launches, plain_on_cuda, cluster_launches, cluster_frames)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout, layout_for
from qkd_ldpc_v_tpu_torch.ops.counts import (
    KernelCounts,
    stream_of,
)
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu_torch.ops.launch import (
    MAX_SHARED_BYTES,
    cached_plans,
    edge_offsets,
    generic_decoder,
    generic_trial,
    pointers,
    to_slot_major,
)


class StreamCounts(KernelCounts):
    """``KernelCounts`` and the trial launches and frames that took the
    cluster kernel."""

    def reset(self) -> None:
        super().reset()
        self.cluster_launches = 0
        self.cluster_frames = 0

    def get(self) -> Tuple[int, int, int, int]:
        """(kernel launches outside the mc mode, plain-version calls on CUDA
        tensors, cluster-kernel launches, frames they decoded)."""
        return (self.launches, self.plain_on_cuda, self.cluster_launches,
                self.cluster_frames)


COUNTS = StreamCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# Frames per group the library carries, narrowest first
# (csrc/generic_stream.cu::Group).
GROUPS = (8, 16)
# Threads per block: one 1024-thread block per SM.
THREADS = 1024


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


# Whether Alice's syndrome plane sits beside the decisions in shared memory
# (csrc/generic_stream.cu::Group::kSynShared); else it is in the block's
# slice of the scratch.
_SYN_SHARED = {8: True, 16: False}


def _check_group(group: int) -> None:
    if group not in GROUPS:
        raise ValueError(f"streamed generic kernel: group size {group} "
                         f"is not one of {GROUPS}")


def shared_bytes(n: int, m: int, group: int = GROUPS[0]) -> int:
    """Dynamic shared memory of one block: the decision plane and, where it
    is shared, the syndrome plane, group / 8 bytes per node, rounded up to
    16 (csrc/generic_stream.cu::group_shared_bytes; a card test holds it
    equal to the library's)."""
    _check_group(group)
    return _round_up(group // 8 * (n + (m if _SYN_SHARED[group] else 0)), 16)


def scratch_bytes(n: int, m: int, e: int, group: int, trial: bool) -> int:
    """Bytes of one block's slice of the scratch (``slice_of``): the
    messages [E, F] f32, then Bob's and Alice's bit planes (trial) or the
    LLR plane [N, F] f32 (decode), then the syndrome plane where it is not
    shared, each at a 256-byte boundary."""
    _check_group(group)
    mask = group // 8
    chan = _round_up(4 * e * group, 256)
    alice = _round_up(chan + (mask * n if trial else 4 * n * group), 256)
    syn = _round_up(alice + (mask * n if trial else 0), 256)
    return _round_up(syn + (0 if _SYN_SHARED[group] else mask * m), 256)


def launch_shape(batch: int, resident: int, n: int, m: int, e: int,
                 group: int, trial: bool) -> Tuple[int, int, int]:
    """(groups, grid, scratch bytes) of one launch: ceil(batch / F) groups
    over a persistent grid of at most ``resident`` blocks, each with its
    slice of the scratch."""
    groups = -(-batch // group)
    grid = min(groups, resident)
    return groups, grid, grid * scratch_bytes(n, m, e, group, trial)


def group_for(batch: int, resident: Dict[int, int]) -> int:
    """The group size of a launch of ``batch`` frames among the sizes that
    fit (``resident``: blocks per size): the widest whose groups fill its
    resident grid, else the narrowest. A wider group moves its messages in
    longer runs, but below a full grid it leaves SMs idle."""
    fits = sorted(resident)
    return next((g for g in reversed(fits) if -(-batch // g) >= resident[g]),
                fits[0])


def check_shared_memory(n: int, m: int, group: int = GROUPS[0]) -> None:
    """Raise before any launch where a group's node planes do not fit in a
    block's shared memory."""
    need = shared_bytes(n, m, group)
    if need > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"streamed generic kernel: the node planes of a group of {group} "
            f"frames (N={n}, M={m}) take {need} bytes of shared memory, "
            f"more than a block's {MAX_SHARED_BYTES}")


# The cluster kernel (csrc/generic_cluster.cu): its cluster sizes, smallest
# first, and group sizes (frames a cluster decodes at once); degree groups a
# side (kMaxGroups) and edges a check (kMaxDegree); the bits of a check
# edge's table word below its rank (kLocalBits), and of a bit edge's word
# below its check (kSlotBits). A card test holds the layout to the
# library's.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_FRAMES = (1, 2, 4, 8)
MAX_GROUPS = 32
MAX_DEGREE = 32
_LOCAL_BITS = 24
_SLOT_BITS = 5
# Scratch bytes before the clusters' records: the frame counter.
_COUNTER_BYTES = 256
# The largest group the plan takes.
PLAN_FRAMES = 8


@dataclass(frozen=True)
class ClusterPlan:
    """The cluster kernel's launch shape for one code: frames a cluster
    decodes at once, CTAs per cluster, threads and shared bytes per CTA,
    bytes of one cluster's records (its frames' compressed checks), and
    bytes of the tables every cluster reads (csrc/generic_cluster.cu's
    ``threads_for``, ``shared_layout`` and ``record_bytes``)."""

    frames: int
    cluster: int
    threads: int
    shared_bytes: int
    record_bytes: int
    table_bytes: int

    def working_set(self, clusters: int) -> int:
        """Bytes the clusters in flight keep in L2: their records and the
        tables."""
        return clusters * self.record_bytes + self.table_bytes


def _share(count: int, cluster: int) -> int:
    """One CTA's share of ``count`` nodes: count / C rounded up to 32."""
    return (-(-count // cluster) + 31) // 32 * 32


def cluster_shared_bytes(n: int, m: int, frames: int, cluster: int) -> int:
    """One CTA's shared bytes: the degree groups of both sides, the cluster
    votes and the next frames, the syndrome bits of its checks for each
    frame, then its share of the f32 totals and of Alice's and Bob's packed
    bits, for each frame."""
    share = _share(n, cluster) * frames
    size = _round_up(16 * 2 * MAX_GROUPS + 4 * 2 * 16 + 4, 16)
    size = _round_up(size + _share(m, cluster) * frames // 8, 16)
    return size + 4 * share + 2 * (share // 8)


def cluster_plan(mode: str, spa: bool, n: int, m: int, e: int,
                 max_check_degree: int, check_groups: int = 1,
                 bit_groups: int = 1,
                 frames: Optional[int] = None) -> Optional[ClusterPlan]:
    """The cluster kernel's plan for a launch in ``mode`` of the SPA pair
    (``spa``) or the min-sum family on a code of ``n`` bits, ``m`` checks
    and ``e`` edges, or None where the batch-minor kernel takes it: decode
    mode (its f32 LLR plane changes the fit), the SPA pair (no two-minimum
    form), a check of more than ``MAX_DEGREE`` edges or more than
    ``MAX_GROUPS`` degree groups a side, or a frame whose per-CTA share fits
    no cluster. The group (frames a cluster decodes at once; ``frames`` pins
    it) is the largest up to ``PLAN_FRAMES`` that one CTA holds, which keeps
    every total local; where one CTA holds no frame, ``PLAN_FRAMES`` frames
    (fewer where no cluster holds that many) in the smallest cluster whose
    per-CTA share fits in 227 KB."""
    if (mode != "trial" or spa or max_check_degree > MAX_DEGREE
            or max(check_groups, bit_groups) > MAX_GROUPS):
        return None
    groups = ([frames] if frames else
              [f for f in CLUSTER_FRAMES if f <= PLAN_FRAMES][::-1])
    if not frames:
        one = [f for f in groups
               if cluster_shared_bytes(n, m, f, 1) <= MAX_SHARED_BYTES]
        groups = one[:1] or groups
    for f in groups:
        for c in CLUSTER_SIZES:
            size = cluster_shared_bytes(n, m, f, c)
            if size <= MAX_SHARED_BYTES:
                return ClusterPlan(
                    f, c, min(THREADS, f * max(_share(n, c), _share(m, c))),
                    size, _round_up(16 * m * f, 256),
                    4 * (4 * (check_groups + bit_groups) + 2 * e + n))
    return None


def _layout_plan(layout: EdgeLayout, mode: str, spa: bool,
                 frames: Optional[int] = None) -> Optional[ClusterPlan]:
    """``cluster_plan`` of a code's layout."""
    return cluster_plan(mode, spa, layout.num_bits, layout.num_checks,
                 layout.num_edges, max(g.degree for g in layout.check_groups),
                 len(layout.check_groups), len(layout.bit_groups), frames)


def launch_tables(layout: EdgeLayout) -> np.ndarray:
    """The batch-minor kernel's index tables, concatenated as int32:
    cptr[M+1], cbit[E], bptr[N+1], bedge[E], bit_ext[N], chk_ext[M] (see
    the header of csrc/generic_decode.cuh)."""
    parts = [
        edge_offsets(layout.check_groups, layout.num_checks),
        layout.check_edge_bit,
        edge_offsets(layout.bit_groups, layout.num_bits),
        layout.to_bit_major,
        layout.bit_order,
        layout.check_order,
    ]
    return np.concatenate([np.asarray(x, dtype=np.int64) for x in parts]
                          ).astype(np.int32)


def cluster_tables(layout: EdgeLayout, cluster: int) -> np.ndarray:
    """The cluster kernel's tables, concatenated as int32: the check and bit
    degree groups as (node_start, count, degree, edge_offset); each check
    edge's bit as ``rank << 24 | local`` (its CTA and its index in that
    CTA's share) and each bit edge's ``check << 5 | slot``, both slot-major
    within their degree groups; each internal bit's external index."""
    share = _share(layout.num_bits, cluster)
    groups = [(g.node_start, g.count, g.degree, g.edge_offset)
              for g in layout.check_groups + layout.bit_groups]
    cbit = np.asarray(layout.check_edge_bit, dtype=np.int64)
    cword = (cbit // share) << _LOCAL_BITS | cbit % share
    cptr = edge_offsets(layout.check_groups, layout.num_checks)
    check_of = np.repeat(np.arange(layout.num_checks), np.diff(cptr))
    pos = np.asarray(layout.to_bit_major, dtype=np.int64)
    bword = check_of[pos] << _SLOT_BITS | (pos - cptr[check_of[pos]])
    parts = [
        np.asarray(groups, dtype=np.int64).reshape(-1),
        to_slot_major(layout.check_groups, cword),
        to_slot_major(layout.bit_groups, bword),
        layout.bit_order,
    ]
    return np.concatenate([np.asarray(x, dtype=np.int64) for x in parts]
                          ).astype(np.int32)


class _Launch:
    """Launch plan of one code, algorithm family, device and group size
    (``None``: each launch's own, ``group_for``): the index tables on the
    device and the resident blocks of each group size whose planes fit;
    where ``group`` is None and ``cluster_plan`` gives one, the cluster
    kernel's plan (``cluster``), tables and the clusters that fit at once
    (``clusters``), which the trial mode takes. ``launch`` launches one
    mode."""

    def __init__(self, matrix: HMatrix, flags: int, device: torch.device,
                 group: Optional[int], frames: Optional[int] = None):
        layout = layout_for(matrix)
        self.n, self.m, self.e = layout.num_bits, layout.num_checks, layout.num_edges
        if group is None:
            sizes = [g for g in GROUPS
                     if shared_bytes(self.n, self.m, g) <= MAX_SHARED_BYTES]
            check_shared_memory(self.n, self.m, GROUPS[0])
        else:
            _check_group(group)
            check_shared_memory(self.n, self.m, group)
            sizes = [group]
        self.resident = {}
        for g in sizes:
            with torch.cuda.device(device):
                blocks = kernels.library().generic_stream_resident_blocks(
                    self.n, self.m, flags, g, THREADS)
            if blocks <= 0:
                raise RuntimeError(
                    f"streamed generic kernel: no block of group size {g} "
                    f"fits on {device} (CUDA error {-blocks})")
            self.resident[g] = blocks
        self.table = torch.tensor(launch_tables(layout), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), self.n, self.m, self.e)
        self.cluster = (None if group is not None else
                        _layout_plan(layout, "trial", bool(flags >> 2),
                                     frames))
        if self.cluster is not None:
            with torch.cuda.device(device):
                self.clusters = kernels.library().generic_cluster_resident(
                    self.n, self.m, flags, self.cluster.frames,
                    self.cluster.cluster)
            if self.clusters <= 0:
                raise RuntimeError(
                    f"streamed generic kernel: no cluster of "
                    f"{self.cluster.cluster} CTAs fits on {device} (CUDA "
                    f"error {-self.clusters})")
            self.cluster_table = torch.tensor(
                cluster_tables(layout, self.cluster.cluster),
                dtype=torch.int32, device=device)
            self.cluster_shape = (
                self.cluster_table.data_ptr(), self.n, self.m, self.e,
                len(layout.check_groups), len(layout.bit_groups))

    def launch(self, mode: str, batch: int, inputs, scalars, outs) -> int:
        """Launch a kernel's entry of ``mode`` on ``batch`` frames and return
        its CUDA error code (``inputs``, ``scalars`` and ``outs``: see
        ``launch.kernel_trial``): the cluster kernel for a trial where the
        plan has one, else the batch-minor kernel at the launch's group size
        over a persistent grid, each block with its slice of the scratch.
        The scratch is freed once the launch is queued; the caching
        allocator reuses it only in stream order."""
        if mode == "trial" and self.cluster is not None:
            return self._cluster_trial(batch, inputs, scalars, outs)
        group = group_for(batch, self.resident)
        _, grid, nbytes = launch_shape(batch, self.resident[group], self.n,
                                       self.m, self.e, group, mode == "trial")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=outs[0].device)
        return getattr(kernels.library(), f"generic_stream_{mode}")(
            *inputs, *self.shape, *scalars, group, scratch.data_ptr(), grid,
            THREADS, *pointers(*outs), stream_of(outs[0]))

    def _cluster_trial(self, batch: int, inputs, scalars, outs) -> int:
        """A trial launch of the cluster kernel over as many clusters as fit
        at once (at most one a group of frames), counted in ``COUNTS`` where
        it launched."""
        plan = self.cluster
        clusters = min(-(-batch // plan.frames), self.clusters)
        scratch = torch.empty(_COUNTER_BYTES + clusters * plan.record_bytes,
                              dtype=torch.uint8, device=outs[0].device)
        err = kernels.library().generic_cluster_trial(
            *inputs, *self.cluster_shape, *scalars, scratch.data_ptr(),
            plan.frames, plan.cluster, clusters, *pointers(*outs),
            stream_of(outs[0]))
        if err == 0:
            COUNTS.cluster_launches += 1
            COUNTS.cluster_frames += batch
        return err


_PLANS = {group: cached_plans(
    lambda matrix, flags, device, group=group: _Launch(matrix, flags, device,
                                                       group))
    for group in (None, *GROUPS)}


def launch_plan(matrix: HMatrix, flags: int, device,
                group: Optional[int] = None) -> _Launch:
    """The cached launch plan of a code, template flags
    (``launch.generic_flags``), device and group size (``None``: chosen per
    launch)."""
    if group is not None:
        _check_group(group)
    return _PLANS[group](matrix, flags, device)


def make_generic_stream_trial(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    group: Optional[int] = None,
) -> Callable:
    """Streamed Monte-Carlo trial, ``group`` frames per block (``None``:
    chosen per launch by ``group_for``).

    ``trial(alice [B,N] int8, bob [B,N] int8, log_p, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``, with ``log_p`` the float32 channel-LLR
    magnitude from ``channel.log_ratio``. ``trial.plain`` is the plain torch
    version with the same signature.
    """
    if group is not None:
        _check_group(group)
    return generic_trial("streamed generic", COUNTS, _PLANS[group], matrix,
                         algorithm, max_iterations, use_threshold)


def make_generic_stream_decoder(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    group: Optional[int] = None,
) -> Callable[..., DecodeResult]:
    """Streamed decode, ``group`` frames per block (``None``: chosen per
    launch): ``decode(llr [B,N] f32, syndrome [B,M] int8, primary,
    secondary, threshold) -> DecodeResult``. ``decode.plain`` is the plain
    torch version with the same signature."""
    if group is not None:
        _check_group(group)
    return generic_decoder("streamed generic", COUNTS, _PLANS[group], matrix,
                           algorithm, max_iterations, use_threshold)
