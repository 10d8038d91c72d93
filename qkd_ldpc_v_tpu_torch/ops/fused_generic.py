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
raises. There is no fallback from a failed launch. ``generic_trial`` and
``generic_decoder`` are that wrapper (``fused_qc.kernel_trial`` /
``kernel_decoder``) with the generic plain versions; the streamed generic
kernel (``ops/generic_stream.py``) uses them with its own launch plan.
``make_fused_generic_frame_trial`` is ``fused_qc.kernel_frame_trial`` with
the generic plain version.

``generic_feasible(matrix)`` is this port's gate for the ``generic``
engine. It picks exactly the codes that the JAX package's
``generic_plan_feasible`` picks: its edge space in the TPU kernel's
degree-grouped 128-lane plane layout needs at most ``MAX_TILES``
128 x 128 tiles (about N = 32k at bit degree 2). The kernel serves every
code inside it.

Counters: as ``fused_qc.KernelCounts`` (``launches``, ``mc_launches``,
``plain_calls``, ``plain_on_cuda``); ``reset_counts`` zeroes them and
``counts`` reads ``(launches, plain_on_cuda)``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout, layout_for
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import (
    DecodeResult,
    frame_trial,
    get_decoder,
    make_trial,
)
from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
    MAX_SHARED_BYTES,
    KernelCounts,
    cached_plans,
    check_flags,
    kernel_decoder,
    kernel_frame_trial,
    kernel_montecarlo,
    kernel_trial,
    pointers,
    stream_of,
)

COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The JAX package's gate (pallas_generic.py: MAX_TILES tiles of LANES x
# LANES edge rows), copied as a predicate.
MAX_TILES = 4
LANES = 128

# Threads per block. At the 10k alist code (one block per SM, messages in
# shared memory) a 16384-frame trial took 40.2 ms at 1024 threads, 45.9 ms
# at 512 and 72.0 ms at 256 (NVIDIA H100 80GB HBM3, 700 W): more warps
# hide more of the latency of the dependent table and message accesses.
THREADS = 1024

_SIGNATURES_SET = False


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


def _lib() -> ctypes.CDLL:
    global _SIGNATURES_SET
    lib = kernels.library()
    if not _SIGNATURES_SET:
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        lib.fused_generic_trial.argtypes = [
            p, p, i, p, i, i, i, i, i, i, f, f, f, f, p, i, i, i, p, p, p, p]
        lib.fused_generic_trial.restype = i
        lib.fused_generic_decode.argtypes = [
            p, p, i, p, i, i, i, i, i, i, f, f, f, p, i, i, i, p, p, p, p]
        lib.fused_generic_decode.restype = i
        lib.fused_generic_frame.argtypes = lib.fused_generic_decode.argtypes
        lib.fused_generic_frame.restype = i
        lib.fused_generic_mc.argtypes = [
            u, u, i, i, i, p, i, i, i, i, i, i, f, f, f, f, p, i, i, i, p, p,
            p, p]
        lib.fused_generic_mc.restype = i
        lib.fused_generic_resident_blocks.argtypes = [i, i, i, i, i, i, i]
        lib.fused_generic_resident_blocks.restype = i
        lib.fused_generic_shared_bytes.argtypes = [i, i, i, i, i]
        lib.fused_generic_shared_bytes.restype = ctypes.c_longlong
        _SIGNATURES_SET = True
    return lib


def launch_tables(layout: EdgeLayout) -> np.ndarray:
    """The kernel's index tables, concatenated as int32: cptr[M+1],
    cbit[E], bptr[N+1], bedge[E], bit_ext[N], chk_ext[M] (see the header
    of csrc/generic_decode.cuh), shared by both generic kernels."""

    def offsets(groups, count):
        deg = np.zeros(count, dtype=np.int64)
        for g in groups:
            deg[g.node_start:g.node_start + g.count] = g.degree
        return np.concatenate([[0], np.cumsum(deg)])

    parts = [
        offsets(layout.check_groups, layout.num_checks),
        layout.check_edge_bit,
        offsets(layout.bit_groups, layout.num_bits),
        layout.to_bit_major,
        layout.bit_order,
        layout.check_order,
    ]
    return np.concatenate([np.asarray(x, dtype=np.int64) for x in parts]
                          ).astype(np.int32)


class _Launch:
    """Launch plan of one code, algorithm family and device: the index
    tables on the device and, for the mc mode and for the other modes
    (compiled apart; the mc mode's selection state takes shared memory of
    its own), where the messages live and the persistent grid's size.
    ``trial``, ``mc``, ``frame`` and ``decode`` launch the kernel and
    return its CUDA error code (arguments: see ``fused_qc.kernel_trial``,
    ``fused_qc.kernel_montecarlo``, ``fused_qc.kernel_frame_trial`` and
    ``fused_qc.kernel_decoder``)."""

    def __init__(self, matrix: HMatrix, flags: int, device: torch.device):
        layout = layout_for(matrix)
        self.n, self.m, self.e = layout.num_bits, layout.num_checks, layout.num_edges
        if not generic_feasible(matrix):
            raise NotImplementedError(
                f"fused generic kernel: the code (N={self.n}, E={self.e}) is "
                "outside the generic engine's gate; larger codes need the "
                "streamed generic kernel (ops/generic_stream.py)"
            )
        lib = _lib()
        self.msg_shared, self.resident = {}, {}
        for mc in (False, True):
            shared = {s: lib.fused_generic_shared_bytes(
                self.n, self.m, self.e, s, int(mc)) for s in (1, 0)}
            self.msg_shared[mc] = int(shared[1] <= MAX_SHARED_BYTES)
            if shared[self.msg_shared[mc]] > MAX_SHARED_BYTES:
                raise NotImplementedError(
                    f"fused generic kernel: {shared[0]} bytes of shared "
                    f"memory per block exceed {MAX_SHARED_BYTES} "
                    f"(N={self.n}, M={self.m})")
            with torch.cuda.device(device):
                resident = lib.fused_generic_resident_blocks(
                    self.n, self.m, self.e, flags, self.msg_shared[mc],
                    THREADS, int(mc))
            if resident <= 0:
                raise RuntimeError(
                    f"fused generic kernel: no block fits on {device} "
                    f"(CUDA error {-resident})")
            self.resident[mc] = resident
        self.table = torch.tensor(launch_tables(layout), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), self.n, self.m, self.e)

    def _scratch(self, batch: int, device, mc: bool = False):
        """(scratch or None, grid) of one launch. The scratch (messages not
        shared) is freed once the launch is queued; the caching allocator
        reuses it only in stream order."""
        grid = min(batch, self.resident[mc])
        if self.msg_shared[mc]:
            return None, grid
        return torch.empty((grid, self.e), dtype=torch.float32,
                           device=device), grid

    def trial(self, alice, bob, scalars, outs) -> int:
        scratch, grid = self._scratch(alice.shape[0], alice.device)
        return _lib().fused_generic_trial(
            *pointers(alice, bob), alice.shape[0], *self.shape, *scalars,
            _ptr(scratch), self.msg_shared[False], grid, THREADS,
            *pointers(*outs), stream_of(alice))

    def mc(self, draw, scalars, outs) -> int:
        scratch, grid = self._scratch(draw[-1], outs[0].device, mc=True)
        return _lib().fused_generic_mc(
            *draw, *self.shape, *scalars, _ptr(scratch), self.msg_shared[True],
            grid, THREADS, *pointers(*outs), stream_of(outs[0]))

    def frame(self, alice, llr, scalars, outs) -> int:
        scratch, grid = self._scratch(alice.shape[0], alice.device)
        return _lib().fused_generic_frame(
            *pointers(alice, llr), alice.shape[0], *self.shape, *scalars,
            _ptr(scratch), self.msg_shared[False], grid, THREADS,
            *pointers(*outs), stream_of(alice))

    def decode(self, llr, syndrome, scalars, outs) -> int:
        scratch, grid = self._scratch(llr.shape[0], llr.device)
        return _lib().fused_generic_decode(
            *pointers(llr, syndrome), llr.shape[0], *self.shape, *scalars,
            _ptr(scratch), self.msg_shared[False], grid, THREADS,
            *pointers(*outs), stream_of(llr))


_launch_plan = cached_plans(_Launch)


def _flags(algorithm: DecodingAlgorithm) -> int:
    """The generic kernels' template flags: bit 0 adaptive, bit 1 offset
    (OMSA/AOMSA), bits 2-3 the check update (``fused_qc.check_flags``: 4
    SPA, 8 SPA-lin)."""
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return (int(algorithm.is_adaptive) | (int(offset) << 1)
            | (check_flags(algorithm) << 2))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def generic_trial(kernel: str, counts: KernelCounts, plan_for: Callable,
                  matrix: HMatrix, algorithm: DecodingAlgorithm,
                  max_iterations: int, use_threshold: bool) -> Callable:
    """``fused_qc.kernel_trial`` of a generic kernel, with the generic plain
    version: the f32 generic torch decoder, ``calculate_syndrome`` and the
    key compare."""
    plain = make_trial(layout_for(matrix), algorithm, max_iterations,
                       use_threshold, torch.float32)
    return kernel_trial(kernel, counts, plan_for, matrix,
                        _flags(algorithm), matrix.num_bit_nodes,
                        max_iterations, use_threshold, plain)


def generic_montecarlo(kernel: str, counts: KernelCounts, plan_for: Callable,
                       matrix: HMatrix, algorithm: DecodingAlgorithm,
                       max_iterations: int, use_threshold: bool) -> Callable:
    """``fused_qc.kernel_montecarlo`` of a generic kernel, with the generic
    plain trial."""
    plain = make_trial(layout_for(matrix), algorithm, max_iterations,
                       use_threshold, torch.float32)
    return kernel_montecarlo(kernel, counts, plan_for, matrix,
                             _flags(algorithm), matrix.num_bit_nodes,
                             max_iterations, use_threshold, plain)


def generic_decoder(kernel: str, counts: KernelCounts, plan_for: Callable,
                    matrix: HMatrix, algorithm: DecodingAlgorithm,
                    max_iterations: int,
                    use_threshold: bool) -> Callable[..., DecodeResult]:
    """``fused_qc.kernel_decoder`` of a generic kernel, with the f32 generic
    torch decoder as its plain version."""
    plain = get_decoder(layout_for(matrix), algorithm, max_iterations,
                        use_threshold, torch.float32)
    return kernel_decoder(kernel, counts, plan_for, matrix,
                          _flags(algorithm), matrix.num_bit_nodes,
                          matrix.num_check_nodes, max_iterations,
                          use_threshold, plain)


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
                              _flags(algorithm), matrix.num_bit_nodes,
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
