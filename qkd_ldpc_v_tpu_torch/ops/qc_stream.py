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

``qc_stream_feasible`` is the JAX package's gate for its ``qc_stream``
engine, copied as a predicate so that ``simulation.select_engine`` names the
engine JAX would run. Its byte budget is the TPU kernel's VMEM and says
nothing about this kernel, whose own limits are ``MAX_LIFTING``,
``MAX_BLOCK_EDGES`` and ``MAX_BASE_CHECKS``.

The wrapper body (checks, device routing, outputs, counting) is
``fused_qc.qc_trial`` / ``qc_montecarlo`` / ``qc_decoder``, shared with the
fused QC kernel; this module gives it the streamed kernel's launch plan.

Counters: as ``fused_qc.KernelCounts`` (``launches``, ``mc_launches``,
``plain_calls``, ``plain_on_cuda``); ``reset_counts`` zeroes them and
``counts`` reads ``(launches, plain_on_cuda)``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
    KernelCounts,
    cached_plans,
    block_edge_table,
    limit_reason,
    pointers,
    qc_decoder,
    qc_montecarlo,
    qc_trial,
    stream_of,
)
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import base_tables

COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The kernel's limits (csrc/qc_stream.cu: kMaxLifting, kMaxBlockEdges,
# kMaxBaseChecks; a card test holds them equal to the library's).
MAX_LIFTING = 32768
MAX_BLOCK_EDGES = 1024
MAX_BASE_CHECKS = 1024

# The JAX package's gate (pallas_qc_stream.py: _MAX_BLOCK_EDGES, the 72 MiB
# VMEM budget at its 8-frame tile, 128-lane lifting sizes).
_JAX_MAX_BLOCK_EDGES = 420
_JAX_BUDGET = 72 * 1024 * 1024
_JAX_TILE = 8
_JAX_LANES = 128

_SIGNATURES_SET = False


def qc_stream_feasible(qc: QCMatrix) -> bool:
    """The JAX package's ``qc_stream_feasible`` verdict: Z a multiple of 128,
    1-420 block edges, every base row non-empty, and the TPU kernel's
    resident planes within its VMEM budget."""
    if qc.lifting % _JAX_LANES:
        return False
    rows, _, num_be = base_tables(qc)
    if num_be == 0 or num_be > _JAX_MAX_BLOCK_EDGES:
        return False
    if any(not r for r in rows):
        return False
    max_deg = max(len(r) for r in rows)
    units = 3 * qc.base_bits + qc.base_checks + 2 * max_deg + 6
    return units * _JAX_TILE * qc.lifting * 4 <= _JAX_BUDGET


def _check_limits(qc: QCMatrix) -> None:
    reason = limit_reason(qc, MAX_LIFTING, MAX_BLOCK_EDGES, MAX_BASE_CHECKS)
    if reason is not None:
        raise NotImplementedError(f"streamed QC kernel: {reason}")


def _lib() -> ctypes.CDLL:
    global _SIGNATURES_SET
    lib = kernels.library()
    if not _SIGNATURES_SET:
        p, i, f, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong, ctypes.c_uint)
        lib.qc_stream_trial.argtypes = [
            p, p, i, p, i, i, i, i, i, i, i, f, f, f, f, p, ll, i, p, p, p, p]
        lib.qc_stream_trial.restype = i
        lib.qc_stream_decode.argtypes = [
            p, p, i, p, i, i, i, i, i, i, i, f, f, f, p, ll, i, p, p, p, p]
        lib.qc_stream_decode.restype = i
        lib.qc_stream_mc.argtypes = [
            u, u, i, i, i, p, i, i, i, i, i, i, i, f, f, f, f, p, ll, i, p,
            p, p, p]
        lib.qc_stream_mc.restype = i
        lib.qc_stream_scratch_floats.argtypes = [i, i, i, i, i, i]
        lib.qc_stream_scratch_floats.restype = ll
        lib.qc_stream_resident_blocks.argtypes = [i, i, i, i, i]
        lib.qc_stream_resident_blocks.restype = i
        for name in ("qc_stream_max_lifting", "qc_stream_max_block_edges",
                     "qc_stream_max_base_checks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        _SIGNATURES_SET = True
    return lib


# The kernel's modes (csrc/qc_stream.cu: Mode), by which its scratch size
# and, for mc, its shared memory and resident blocks differ.
_MODES = {"decode": 0, "trial": 1, "mc": 2}


class _Launch:
    """Launch plan of one code, kernel variant and device: the block-edge
    table on the device and, per mode, the persistent grid's size and each
    block's scratch floats. ``trial``, ``mc`` and ``decode`` allocate the
    grid's global scratch, launch the kernel and return its CUDA error code
    (arguments: see ``fused_qc.qc_trial``, ``fused_qc.kernel_montecarlo``
    and ``fused_qc.qc_decoder``)."""

    def __init__(self, qc: QCMatrix, flags: int, device: torch.device):
        _check_limits(qc)
        mb, nb, z, num_be = (qc.base_checks, qc.base_bits, qc.lifting,
                             len(qc.block_edges))
        self.resident = {}
        for mode in _MODES:
            with torch.cuda.device(device):
                resident = _lib().qc_stream_resident_blocks(
                    mb, z, num_be, flags, int(mode == "mc"))
            if resident <= 0:
                raise RuntimeError(
                    f"streamed QC kernel: no block fits on {device} "
                    f"(CUDA error {-resident})")
            self.resident[mode] = resident
        self.per_block = {
            mode: _lib().qc_stream_scratch_floats(mb, nb, z, num_be, flags,
                                                  code)
            for mode, code in _MODES.items()}
        self.table = torch.tensor(block_edge_table(qc), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), mb, nb, z, num_be)

    def _scratch(self, batch: int, mode: str, device):
        """(scratch tensor, floats per block, grid) of one launch. The
        scratch is freed once the launch is queued; the caching allocator
        reuses it only in stream order."""
        grid = min(batch, self.resident[mode])
        per_block = self.per_block[mode]
        scratch = torch.empty(grid * per_block, dtype=torch.float32,
                              device=device)
        return scratch, per_block, grid

    def trial(self, alice, bob, scalars, outs) -> int:
        scratch, per_block, grid = self._scratch(alice.shape[0], "trial",
                                                 alice.device)
        return _lib().qc_stream_trial(
            *pointers(alice, bob), alice.shape[0], *self.shape, *scalars,
            scratch.data_ptr(), per_block, grid, *pointers(*outs),
            stream_of(alice))

    def mc(self, draw, scalars, outs) -> int:
        scratch, per_block, grid = self._scratch(draw[-1], "mc",
                                                 outs[0].device)
        return _lib().qc_stream_mc(
            *draw, *self.shape, *scalars, scratch.data_ptr(), per_block, grid,
            *pointers(*outs), stream_of(outs[0]))

    def decode(self, llr, syndrome, scalars, outs) -> int:
        scratch, per_block, grid = self._scratch(llr.shape[0], "decode",
                                                 llr.device)
        return _lib().qc_stream_decode(
            *pointers(llr, syndrome), llr.shape[0], *self.shape, *scalars,
            scratch.data_ptr(), per_block, grid, *pointers(*outs),
            stream_of(llr))


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
