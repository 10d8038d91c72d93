"""Streamed generic decoder: wrappers of the hand-written CUDA kernel for
arbitrary sparse codes whose per-frame state does not fit in one block's
shared memory, and their plain torch versions.

Counterpart of ``qkd_ldpc_v_tpu/ops/pallas_stream.py``
(``make_pallas_stream_trial`` and ``make_pallas_stream_decoder``; the
kernel is ``csrc/generic_stream.cu``, which replaces that module's four
kernels and its while-loop), for the min-sum family NMSA, OMSA, ANMSA and
AOMSA on the flooding schedule:

  * ``make_generic_stream_trial`` — the Monte-Carlo sweep's hot path for
    the N=102400 alist code: Alice's and Bob's keys in, per-frame
    ``(syndromes_match, keys_match, iterations)`` out;
  * ``make_generic_stream_decoder`` — the library decode: LLRs and a
    syndrome in, a ``DecodeResult`` out.

Both have the signatures and returns of ``ops/fused_generic.py``'s
wrappers and the same plain versions (the f32 generic torch decoder plus
``calculate_syndrome`` and the key compare), so the two generic kernels
give identical results wherever both run. The wrapper body is
``fused_generic.generic_trial`` / ``generic_decoder``; this module gives it
the streamed kernel's launch plan. Routing is by the tensors' device and
nothing else: CPU tensors go to the plain version, CUDA tensors launch the
kernel (or raise), and any other device raises. There is no fallback from
a failed launch.

The kernel keeps the messages in a global scratch and a frame's decisions
and syndrome (N + M bytes) in shared memory; ``check_shared_memory`` raises,
naming N and M, before any launch of a code whose planes exceed a block's
shared memory (N + M > 227 KB, e.g. N=200k at rate 0.7).

``stream_feasible`` is the JAX package's gate for its ``stream`` engine,
copied as a predicate so that ``simulation.select_engine`` names the
engine JAX would run; the kernel itself serves any code within its shared
memory (``tpu.force_engine = "stream"`` sends a code inside the generic
gate here too). The JAX sweep's two-phase straggler re-decode for this
engine (``tpu.phase1_iterations``) is not ported: it exists because a TPU
batch tile iterates to its slowest frame, and this kernel exits per frame.

Counters: ``COUNTS.launches`` counts kernel launches;
``COUNTS.plain_on_cuda`` counts plain-version calls on CUDA tensors, which
only tests and the card smoke's comparisons make. ``reset_counts`` zeroes
both and ``counts`` reads them.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu_torch.ops.fused_generic import (
    THREADS,
    generic_decoder,
    generic_trial,
    launch_tables,
)
from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
    MAX_SHARED_BYTES,
    KernelCounts,
    cached_plans,
    pointers,
    stream_of,
)

COUNTS = KernelCounts()
reset_counts = COUNTS.reset
counts = COUNTS.get

# The JAX package's gate (pallas_stream.py::stream_feasible, 128 lanes).
_JAX_LANES = 128

_SIGNATURES_SET = False


def stream_feasible(matrix: HMatrix) -> bool:
    """The JAX package's ``stream_feasible`` verdict: more than 256 edge rows
    of 128 lanes on the bit side at its widest degree, and check degrees
    under 64."""
    if not matrix.bit_nodes or not matrix.check_nodes:
        return False
    dmax_b = max(len(r) for r in matrix.bit_nodes)
    dmax_c = max(len(r) for r in matrix.check_nodes)
    return dmax_b * -(-matrix.num_bit_nodes // _JAX_LANES) > 256 and dmax_c < 64


def shared_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block: decisions and syndrome, N + M
    bytes rounded up to 16 (csrc/generic_decode.cuh::shared_bytes; a card
    test holds it equal to the library's)."""
    return (n + m + 15) // 16 * 16


def check_shared_memory(n: int, m: int) -> None:
    """Raise before any launch where a frame's node planes do not fit in a
    block's shared memory."""
    need = shared_bytes(n, m)
    if need > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"streamed generic kernel: the decisions and syndrome of a frame "
            f"(N={n}, M={m}) take {need} bytes of shared memory, more than "
            f"a block's {MAX_SHARED_BYTES}")


def _lib() -> ctypes.CDLL:
    global _SIGNATURES_SET
    lib = kernels.library()
    if not _SIGNATURES_SET:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.generic_stream_trial.argtypes = [
            p, p, i, p, i, i, i, i, i, i, f, f, f, f, p, i, i, p, p, p, p]
        lib.generic_stream_trial.restype = i
        lib.generic_stream_decode.argtypes = [
            p, p, i, p, i, i, i, i, i, i, f, f, f, p, i, i, p, p, p, p]
        lib.generic_stream_decode.restype = i
        lib.generic_stream_resident_blocks.argtypes = [i, i, i, i]
        lib.generic_stream_resident_blocks.restype = i
        lib.generic_stream_shared_bytes.argtypes = [i, i]
        lib.generic_stream_shared_bytes.restype = ctypes.c_longlong
        _SIGNATURES_SET = True
    return lib


class _Launch:
    """Launch plan of one code, algorithm family and device: the index
    tables on the device and the persistent grid's size. ``trial`` and
    ``decode`` allocate the grid's message scratch, launch the kernel and
    return its CUDA error code (arguments: see ``fused_qc.kernel_trial``
    and ``fused_qc.kernel_decoder``)."""

    def __init__(self, matrix: HMatrix, flags: int, device: torch.device):
        layout = layout_for(matrix)
        self.n, self.m, self.e = layout.num_bits, layout.num_checks, layout.num_edges
        check_shared_memory(self.n, self.m)
        with torch.cuda.device(device):
            resident = _lib().generic_stream_resident_blocks(
                self.n, self.m, flags, THREADS)
        if resident <= 0:
            raise RuntimeError(
                f"streamed generic kernel: no block fits on {device} "
                f"(CUDA error {-resident})")
        self.resident = resident
        self.table = torch.tensor(launch_tables(layout), dtype=torch.int32,
                                  device=device)
        self.shape = (self.table.data_ptr(), self.n, self.m, self.e)

    def _scratch(self, batch: int, device):
        """(scratch, grid) of one launch: E floats of messages per block.
        The scratch is freed once the launch is queued; the caching
        allocator reuses it only in stream order."""
        grid = min(batch, self.resident)
        return torch.empty((grid, self.e), dtype=torch.float32,
                           device=device), grid

    def trial(self, alice, bob, scalars, outs) -> int:
        scratch, grid = self._scratch(alice.shape[0], alice.device)
        return _lib().generic_stream_trial(
            *pointers(alice, bob), alice.shape[0], *self.shape, *scalars,
            scratch.data_ptr(), grid, THREADS, *pointers(*outs),
            stream_of(alice))

    def decode(self, llr, syndrome, scalars, outs) -> int:
        scratch, grid = self._scratch(llr.shape[0], llr.device)
        return _lib().generic_stream_decode(
            *pointers(llr, syndrome), llr.shape[0], *self.shape, *scalars,
            scratch.data_ptr(), grid, THREADS, *pointers(*outs),
            stream_of(llr))


_launch_plan = cached_plans(_Launch)


def make_generic_stream_trial(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable:
    """Streamed Monte-Carlo trial.

    ``trial(alice [B,N] int8, bob [B,N] int8, log_p, primary, secondary,
    threshold) -> (syndromes_match [B] bool, keys_match [B] bool,
    iterations [B] int32)``, with ``log_p`` the float32 channel-LLR
    magnitude from ``channel.log_ratio``. ``trial.plain`` is the plain torch
    version with the same signature.
    """
    return generic_trial("streamed generic", COUNTS, _launch_plan, matrix,
                         algorithm, max_iterations, use_threshold)


def make_generic_stream_decoder(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
) -> Callable[..., DecodeResult]:
    """Streamed decode: ``decode(llr [B,N] f32, syndrome [B,M] int8,
    primary, secondary, threshold) -> DecodeResult``. ``decode.plain`` is
    the plain torch version with the same signature."""
    return generic_decoder("streamed generic", COUNTS, _launch_plan, matrix,
                           algorithm, max_iterations, use_threshold)
