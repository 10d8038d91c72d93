"""Fused generic decoder: wrappers of the hand-written CUDA kernel for
arbitrary sparse parity-check matrices, and their plain torch versions.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_generic.py``
(``make_pallas_generic_trial`` and ``make_pallas_generic_decoder``; the
kernel is ``csrc/fused_generic.cu``), for the min-sum family NMSA, OMSA,
ANMSA and AOMSA on the flooding schedule:

  * ``make_fused_generic_trial`` — the Monte-Carlo sweep's hot path for
    alist / format-1 / format-2 / dense codes: Alice's and Bob's keys in;
    Alice's syndrome, the channel LLRs, the decode and the key comparison
    all happen in the kernel, which returns per-frame ``(syndromes_match,
    keys_match, iterations)``.
  * ``make_fused_generic_decoder`` — the library decode: LLRs and a
    syndrome in, a ``DecodeResult`` out.

The plain version is the generic torch decoder (``ops/decoders.py``) in
float32 plus ``calculate_syndrome`` and the key comparison; the kernel
equals it exactly (decisions, convergence, iterations).

Routing is by the tensors' device and nothing else: CPU tensors go to the
plain version, CUDA tensors launch the kernel, and any other device
raises. There is no fallback from a failed launch.

``generic_feasible(matrix)`` is this port's gate for the ``generic``
engine. It picks exactly the codes that the JAX package's
``generic_plan_feasible`` picks: its edge space in the TPU kernel's
degree-grouped 128-lane plane layout needs at most ``MAX_TILES``
128 x 128 tiles (about N = 32k at bit degree 2). The kernel serves every
code inside it.

Counters: ``LAUNCHES`` counts kernel launches; ``PLAIN_ON_CUDA`` counts
plain-version calls on CUDA tensors, which only tests and the card smoke's
comparisons make. ``reset_counts`` zeroes both.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Tuple

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout, layout_for
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult, get_decoder, make_trial
from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
    MAX_SHARED_BYTES,
    check_tensor,
    raise_on_error,
)
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import MIN_SUM
from qkd_ldpc_v_tpu_torch.utils import PlanCache

LAUNCHES = 0
PLAIN_ON_CUDA = 0

# The JAX package's gate (pallas_generic.py: MAX_TILES tiles of LANES x
# LANES edge rows), copied as a predicate.
MAX_TILES = 4
LANES = 128

# Threads per block. At the 10k alist code (one block per SM, messages in
# shared memory) a 16384-frame trial took 40.2 ms at 1024 threads, 45.9 ms
# at 512 and 72.0 ms at 256 (NVIDIA H100 80GB HBM3, 700 W): more warps
# hide more of the latency of the dependent table and message accesses.
THREADS = 1024

_PLANS = PlanCache()
_SIGNATURES_SET = False


def reset_counts() -> None:
    global LAUNCHES, PLAIN_ON_CUDA
    LAUNCHES = 0
    PLAIN_ON_CUDA = 0


def counts() -> Tuple[int, int]:
    """(kernel launches, plain-version calls on CUDA tensors)."""
    return LAUNCHES, PLAIN_ON_CUDA


def _count_plain(t: torch.Tensor) -> None:
    global PLAIN_ON_CUDA
    if t.device.type == "cuda":
        PLAIN_ON_CUDA += 1


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


def check_algorithm(algorithm: DecodingAlgorithm) -> None:
    if algorithm not in MIN_SUM:
        raise NotImplementedError(
            f"{algorithm.display_name} in the fused generic kernel is not "
            "ported yet: the SPA pair comes after the min-sum family "
            "(ROADMAP, port queue)."
        )


def _lib() -> ctypes.CDLL:
    global _SIGNATURES_SET
    lib = kernels.library()
    if not _SIGNATURES_SET:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_generic_trial.argtypes = [
            p, p, i, p, i, i, i, i, i, i, f, f, f, f, p, i, i, i, p, p, p, p]
        lib.fused_generic_trial.restype = i
        lib.fused_generic_decode.argtypes = [
            p, p, i, p, i, i, i, i, i, i, f, f, f, p, i, i, i, p, p, p, p]
        lib.fused_generic_decode.restype = i
        lib.fused_generic_resident_blocks.argtypes = [i, i, i, i, i, i]
        lib.fused_generic_resident_blocks.restype = i
        lib.fused_generic_shared_bytes.argtypes = [i, i, i, i]
        lib.fused_generic_shared_bytes.restype = ctypes.c_longlong
        _SIGNATURES_SET = True
    return lib


def launch_tables(layout: EdgeLayout) -> np.ndarray:
    """The kernel's index tables, concatenated as int32: cptr[M+1],
    cbit[E], bptr[N+1], bedge[E], bit_ext[N], chk_ext[M] (see the header
    of csrc/fused_generic.cu)."""

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
    tables on the device, where the messages live, and the persistent
    grid's size."""

    def __init__(self, matrix: HMatrix, flags: int, device: torch.device):
        layout = layout_for(matrix)
        self.n, self.m, self.e = layout.num_bits, layout.num_checks, layout.num_edges
        if not generic_feasible(matrix):
            raise NotImplementedError(
                f"fused generic kernel: the code (N={self.n}, E={self.e}) is "
                "outside the generic engine's gate; larger codes need the "
                "streamed generic kernel (ROADMAP)"
            )
        lib = _lib()
        self.msg_shared = int(lib.fused_generic_shared_bytes(
            self.n, self.m, self.e, 1) <= MAX_SHARED_BYTES)
        shared = lib.fused_generic_shared_bytes(self.n, self.m, self.e,
                                                self.msg_shared)
        if shared > MAX_SHARED_BYTES:
            raise NotImplementedError(
                f"fused generic kernel: {shared} bytes of shared memory per "
                f"block exceed {MAX_SHARED_BYTES} (N={self.n}, M={self.m})"
            )
        self.threads = THREADS
        with torch.cuda.device(device):
            resident = lib.fused_generic_resident_blocks(
                self.n, self.m, self.e, flags, self.msg_shared, self.threads)
        if resident <= 0:
            raise RuntimeError(
                f"fused generic kernel: no block fits on {device} "
                f"(CUDA error {-resident})")
        self.resident = resident
        self.table = torch.tensor(launch_tables(layout), dtype=torch.int32,
                                  device=device)

    def grid_and_scratch(self, batch: int, device) -> Tuple[int, torch.Tensor]:
        grid = min(batch, self.resident)
        if self.msg_shared:
            return grid, None
        return grid, torch.empty((grid, self.e), dtype=torch.float32,
                                 device=device)


def _launch_plan(matrix: HMatrix, flags: int, device) -> _Launch:
    key = (flags, str(device))
    plan = _PLANS.get(matrix, extra=key)
    if plan is None:
        plan = _Launch(matrix, flags, device)
        _PLANS.put(matrix, plan, extra=key)
    return plan


def _flags(algorithm: DecodingAlgorithm) -> int:
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return int(algorithm.is_adaptive) | (int(offset) << 1)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


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
    check_algorithm(algorithm)
    n = matrix.num_bit_nodes
    plain_trial = make_trial(layout_for(matrix), algorithm, max_iterations,
                             use_threshold, torch.float32)

    def plain(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        _count_plain(alice)
        return plain_trial(alice, bob, log_p, primary, secondary, threshold)

    def trial(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        global LAUNCHES
        b = alice.shape[0]
        check_tensor("alice", alice, torch.int8, (b, n), alice.device)
        check_tensor("bob", bob, torch.int8, (b, n), alice.device)
        if alice.device.type == "cpu":
            return plain(alice, bob, log_p, primary, secondary, threshold)
        if alice.device.type != "cuda":
            raise NotImplementedError(
                f"fused generic trial: no kernel for device {alice.device}")
        flags = _flags(algorithm)
        plan = _launch_plan(matrix, flags, alice.device)
        conv = torch.empty(b, dtype=torch.int8, device=alice.device)
        keys = torch.empty(b, dtype=torch.int8, device=alice.device)
        iters = torch.empty(b, dtype=torch.int32, device=alice.device)
        if b == 0:
            return conv.bool(), keys.bool(), iters
        grid, scratch = plan.grid_and_scratch(b, alice.device)
        code = _lib().fused_generic_trial(
            alice.data_ptr(), bob.data_ptr(), b, plan.table.data_ptr(),
            plan.n, plan.m, plan.e, flags, int(use_threshold),
            int(max_iterations), float(log_p), float(primary),
            float(secondary), float(threshold), _ptr(scratch),
            plan.msg_shared, grid, plan.threads, conv.data_ptr(),
            keys.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(alice.device).cuda_stream,
        )
        raise_on_error(code, "fused_generic_trial")
        LAUNCHES += 1
        return conv.bool(), keys.bool(), iters

    trial.plain = plain
    return trial


def make_fused_generic_decoder(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable[..., DecodeResult]:
    """Fused decode: ``decode(llr [B,N] f32, syndrome [B,M] int8, primary,
    secondary, threshold) -> DecodeResult``. ``decode.plain`` is the plain
    torch version with the same signature."""
    check_algorithm(algorithm)
    layout = layout_for(matrix)
    n, m = matrix.num_bit_nodes, matrix.num_check_nodes
    decoder = get_decoder(layout, algorithm, max_iterations, use_threshold,
                          torch.float32)

    def plain(llr, syndrome, primary=1.0, secondary=1.0, threshold=0.0):
        _count_plain(llr)
        return decoder(llr, syndrome, primary, secondary, threshold)

    def decode(llr, syndrome, primary=1.0, secondary=1.0, threshold=0.0):
        global LAUNCHES
        b = llr.shape[0]
        check_tensor("llr", llr, torch.float32, (b, n), llr.device)
        check_tensor("syndrome", syndrome, torch.int8, (b, m), llr.device)
        if llr.device.type == "cpu":
            return plain(llr, syndrome, primary, secondary, threshold)
        if llr.device.type != "cuda":
            raise NotImplementedError(
                f"fused generic decoder: no kernel for device {llr.device}")
        flags = _flags(algorithm)
        plan = _launch_plan(matrix, flags, llr.device)
        dec = torch.empty((b, n), dtype=torch.int8, device=llr.device)
        conv = torch.empty(b, dtype=torch.int8, device=llr.device)
        iters = torch.empty(b, dtype=torch.int32, device=llr.device)
        if b == 0:
            return DecodeResult(dec, conv.bool(), iters)
        grid, scratch = plan.grid_and_scratch(b, llr.device)
        code = _lib().fused_generic_decode(
            llr.data_ptr(), syndrome.data_ptr(), b, plan.table.data_ptr(),
            plan.n, plan.m, plan.e, flags, int(use_threshold),
            int(max_iterations), float(primary), float(secondary),
            float(threshold), _ptr(scratch), plan.msg_shared, grid,
            plan.threads, dec.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(llr.device).cuda_stream,
        )
        raise_on_error(code, "fused_generic_decode")
        LAUNCHES += 1
        return DecodeResult(dec, conv.bool(), iters)

    decode.plain = plain
    return decode
