"""Fused QC decoder: wrappers of the hand-written CUDA kernel and their plain
torch versions.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_qc.py`` (``make_pallas_qc_trial``
and ``make_pallas_qc_decoder``; the kernel is ``csrc/fused_qc.cu``):

  * ``make_fused_qc_trial`` — the Monte-Carlo sweep's hot path: Alice's and
    Bob's keys in; Alice's syndrome, the channel LLRs, the decode and the
    key comparison all happen in the kernel, which returns per-frame
    ``(syndromes_match, keys_match, iterations)``.
  * ``make_fused_qc_decoder`` — the library decode: LLRs and a syndrome in,
    a ``DecodeResult`` out.

Routing is by the tensors' device and nothing else: CPU tensors go to the
plain version (``ops/qc_decoder.py``), CUDA tensors launch the kernel, and
any other device raises. There is no fallback from a failed launch.

Counters: ``LAUNCHES`` counts kernel launches; ``PLAIN_ON_CUDA`` counts
plain-version calls on CUDA tensors, which only tests and the card smoke's
comparisons make. ``reset_counts`` zeroes both.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.channel import qc_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import (
    base_tables,
    check_algorithm,
    decode_flooding,
    decode_layered,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache

LAUNCHES = 0
PLAIN_ON_CUDA = 0

# Shared memory one block may use on sm_90 (227 KB).
MAX_SHARED_BYTES = 232448

_TABLES = PlanCache()
_SIGNATURES_SET = False


def reset_counts() -> None:
    global LAUNCHES, PLAIN_ON_CUDA
    LAUNCHES = 0
    PLAIN_ON_CUDA = 0


def _count_plain(t: torch.Tensor) -> None:
    global PLAIN_ON_CUDA
    if t.device.type == "cuda":
        PLAIN_ON_CUDA += 1


def _check_schedule(schedule: str) -> bool:
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return schedule == "layered"


def _plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                  use_threshold, layered, primary, secondary, threshold):
    fn = decode_layered if layered else decode_flooding
    return fn(qc, llr, syndrome, algorithm, max_iterations, use_threshold,
              primary, secondary, threshold)


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
        for name in ("fused_qc_max_lifting", "fused_qc_max_block_edges",
                     "fused_qc_max_base_checks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        _SIGNATURES_SET = True
    return lib


class _Launch:
    """Host-side launch plan of one code on one device: the block-edge table
    (row_ptr[mb+1], cols[num_be], shifts[num_be] int32, storage order) and
    the size checks the kernel needs."""

    def __init__(self, qc: QCMatrix, layered: bool, device: torch.device):
        rows, _, num_be = base_tables(qc)
        row_ptr = [0]
        cols, shifts = [], []
        for row in rows:
            for (_, c, s) in row:
                cols.append(c)
                shifts.append(s)
            row_ptr.append(len(cols))
        self.mb, self.nb, self.z = qc.base_checks, qc.base_bits, qc.lifting
        self.num_be = num_be
        lib = _lib()
        limits = (
            (self.z, lib.fused_qc_max_lifting(), "lifting size Z"),
            (num_be, lib.fused_qc_max_block_edges(), "block edges"),
            (self.mb, lib.fused_qc_max_base_checks(), "base checks"),
        )
        for value, limit, what in limits:
            if value > limit:
                raise NotImplementedError(
                    f"fused QC kernel: {what} = {value} exceeds {limit}; "
                    "larger codes need the streamed QC kernel (ROADMAP)"
                )
        shared = 4 * (self.mb + 1 + 2 * num_be) + \
            (1 if layered else 2) * 4 * qc.num_bit_nodes
        if shared > MAX_SHARED_BYTES:
            raise NotImplementedError(
                f"fused QC kernel: {shared} bytes of shared memory per frame "
                f"exceed {MAX_SHARED_BYTES}; larger codes need the streamed "
                "QC kernel (ROADMAP)"
            )
        self.table = torch.tensor(row_ptr + cols + shifts, dtype=torch.int32,
                                  device=device)


def _launch_plan(qc: QCMatrix, layered: bool, device) -> _Launch:
    key = (layered, str(device))
    plan = _TABLES.get(qc, extra=key)
    if plan is None:
        plan = _Launch(qc, layered, device)
        _TABLES.put(qc, plan, extra=key)
    return plan


def _flags(algorithm: DecodingAlgorithm, layered: bool) -> int:
    offset = algorithm in (DecodingAlgorithm.OMSA, DecodingAlgorithm.AOMSA)
    return int(layered) | (int(algorithm.is_adaptive) << 1) | (int(offset) << 2)


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
    check_algorithm(algorithm)
    layered = _check_schedule(schedule)
    n = qc.num_bit_nodes

    def plain(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        _count_plain(alice)
        lp = torch.tensor(log_p, dtype=torch.float32, device=alice.device)
        llr = torch.where(bob == 1, -lp, lp)
        res = _plain_decode(qc, llr, qc_syndrome(qc, alice), algorithm,
                            max_iterations, use_threshold, layered, primary,
                            secondary, threshold)
        keys = (res.decision == alice).all(dim=1)
        return res.syndromes_match, keys, res.iterations

    def trial(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        global LAUNCHES
        b = alice.shape[0]
        check_tensor("alice", alice, torch.int8, (b, n), alice.device)
        check_tensor("bob", bob, torch.int8, (b, n), alice.device)
        if alice.device.type == "cpu":
            return plain(alice, bob, log_p, primary, secondary, threshold)
        if alice.device.type != "cuda":
            raise NotImplementedError(
                f"fused QC trial: no kernel for device {alice.device}")
        plan = _launch_plan(qc, layered, alice.device)
        conv = torch.empty(b, dtype=torch.int8, device=alice.device)
        keys = torch.empty(b, dtype=torch.int8, device=alice.device)
        iters = torch.empty(b, dtype=torch.int32, device=alice.device)
        if b == 0:
            return conv.bool(), keys.bool(), iters
        code = _lib().fused_qc_trial(
            alice.data_ptr(), bob.data_ptr(), b, plan.table.data_ptr(),
            plan.mb, plan.nb, plan.z, plan.num_be, _flags(algorithm, layered),
            int(use_threshold), int(max_iterations), float(log_p),
            float(primary), float(secondary), float(threshold),
            conv.data_ptr(), keys.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(alice.device).cuda_stream,
        )
        raise_on_error(code, "fused_qc_trial")
        LAUNCHES += 1
        return conv.bool(), keys.bool(), iters

    trial.plain = plain
    return trial


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
    check_algorithm(algorithm)
    layered = _check_schedule(schedule)
    n, m = qc.num_bit_nodes, qc.num_check_nodes

    def plain(llr, syndrome, primary=1.0, secondary=1.0, threshold=0.0):
        _count_plain(llr)
        return _plain_decode(qc, llr, syndrome, algorithm, max_iterations,
                             use_threshold, layered, primary, secondary,
                             threshold)

    def decode(llr, syndrome, primary=1.0, secondary=1.0, threshold=0.0):
        global LAUNCHES
        b = llr.shape[0]
        check_tensor("llr", llr, torch.float32, (b, n), llr.device)
        check_tensor("syndrome", syndrome, torch.int8, (b, m), llr.device)
        if llr.device.type == "cpu":
            return plain(llr, syndrome, primary, secondary, threshold)
        if llr.device.type != "cuda":
            raise NotImplementedError(
                f"fused QC decoder: no kernel for device {llr.device}")
        plan = _launch_plan(qc, layered, llr.device)
        dec = torch.empty((b, n), dtype=torch.int8, device=llr.device)
        conv = torch.empty(b, dtype=torch.int8, device=llr.device)
        iters = torch.empty(b, dtype=torch.int32, device=llr.device)
        if b == 0:
            return DecodeResult(dec, conv.bool(), iters)
        code = _lib().fused_qc_decode(
            llr.data_ptr(), syndrome.data_ptr(), b, plan.table.data_ptr(),
            plan.mb, plan.nb, plan.z, plan.num_be, _flags(algorithm, layered),
            int(use_threshold), int(max_iterations), float(primary),
            float(secondary), float(threshold), dec.data_ptr(),
            conv.data_ptr(), iters.data_ptr(),
            torch.cuda.current_stream(llr.device).cuda_stream,
        )
        raise_on_error(code, "fused_qc_decode")
        LAUNCHES += 1
        return DecodeResult(dec, conv.bool(), iters)

    decode.plain = plain
    return decode


def counts() -> Tuple[int, int]:
    """(kernel launches, plain-version calls on CUDA tensors)."""
    return LAUNCHES, PLAIN_ON_CUDA
