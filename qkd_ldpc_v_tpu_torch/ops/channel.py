"""Batched channel model in plain torch.

Counterpart of ``qkd_ldpc_v_tpu/ops/channel.py`` (reference semantics:
src/array_and_matrix_operations.cpp:889-950):

  * Alice keys: uniform bits per frame.
  * Bob keys: Alice's key with an **exact** count of ``floor(N * QBER)``
    errors at uniformly random distinct positions per frame, chosen as the
    ranks of the smallest per-position sort keys.
  * Syndrome of a QC code: XOR of rolled key blocks per check block.
  * Syndrome of any code: a gather of key bits over the edge layout's
    check-major edges and a parity per check (``calculate_syndrome``).
  * Channel LLRs ``+/- log((1-q)/q)`` (``llr_from_bits``, ``log_ratio``).
  * Rate-adapted frames and their LLRs (``build_frames``), as the JAX
    sweep's rate-adaptive step builds them in XLA.

Random numbers are inputs. ``inject_errors`` takes its per-position random
bits from the caller, so tests can feed the exact bits JAX draws. On CUDA
tensors it is one hand-written kernel (``csrc/inject.cu``: the keys, the
exact selection and the flips in two passes over the words), held bit for
bit to its plain version (``plain_inject_errors``: int64 keys and
``torch.kthvalue``), which CPU tensors run.
``mc_channel`` is the keys of the kernels' mc mode: Alice's bits and the
error sort keys from the Philox stream of a chunk seed (``ops/philox.py``),
with the 32-bit sort-key rule of the JAX mc kernels
(``mc_channel_from_bits``, which the tests feed JAX's stubbed stream).
``simulation.run_combination`` seeds each decode chunk with ``chunk_seed``
(the port's replacement for JAX's threefry ``trial_keys``) and runs the mc
mode on it where the engine has one, else draws keys and bits from one
``torch.Generator`` per chunk (a sharded run seeds each rank's with
``rank_chunk_seed``). The two packages therefore agree
statistically, and exactly only when given the same keys.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.counts import (
    KernelCounts,
    kernel_span,
    raise_on_error,
    stream_of,
)
from qkd_ldpc_v_tpu_torch.ops.philox import ALICE, ERRORS, stream_words
from qkd_ldpc_v_tpu_torch.rate_adapt import ALMOST_ZERO
from qkd_ldpc_v_tpu_torch.utils import PlanCache, span


def exact_error_count(num_bits: int, qber: float) -> int:
    """floor(N * QBER) (reference: src/array_and_matrix_operations.cpp:913)."""
    return int(num_bits * qber)


def log_ratio(qber: float, dtype: torch.dtype = torch.float32) -> float:
    """``log((1 - q) / q)``, the channel-LLR magnitude, as a value exactly
    representable in ``dtype``.

    Computed once on the host, the same way for every device, so that the
    kernels and their plain versions always see the same bits. float32: the
    ratio in float32 (as the JAX sweep forms it from a float32 QBER), then a
    double-precision log rounded to float32. Transcendental f32 ``log``
    differs by an ulp between XLA, NumPy and torch at some QBERs; this rule
    agrees with JAX's XLA log at the QBERs the tests use, which assert it.
    float64: the ratio and the log in double precision, as the JAX sweep
    forms them from a float64 QBER. bfloat16: the float32 value rounded to
    bfloat16 (no exactness claim: JAX rounds its bfloat16 intermediates
    elsewhere).
    """
    if dtype == torch.float64:
        q = float(qber)
        return float(np.log((1.0 - q) / q))
    q = np.float32(qber)
    ratio = np.float32(np.float32(1.0) - q) / q
    value = float(np.float32(math.log(float(ratio))))
    if dtype == torch.float32:
        return value
    return float(torch.tensor(value).to(dtype))


def chunk_seed(simulation_seed: int, sim_number: int, chunk_index: int) -> int:
    """Seed of the generator for one decode chunk.

    Rule: the first 64-bit word of NumPy's ``SeedSequence([seed, sim_number,
    chunk_index])``, masked to 63 bits. Distinct (seed, combination, chunk)
    triples get independent streams, like the reference's per-trial seeding
    (src/simulation.cpp:713-719). It replaces JAX's threefry ``trial_keys``,
    whose bits torch cannot reproduce.
    """
    ss = np.random.SeedSequence([int(simulation_seed), int(sim_number),
                                 int(chunk_index)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def rank_chunk_seed(simulation_seed: int, sim_number: int, chunk_index: int,
                    rank: int) -> int:
    """Seed of rank ``rank``'s generator for one decode chunk of a sharded
    run (``parallel/driver.py``), the counterpart of JAX's ``fold_in`` of
    the device index into the chunk's keys.

    Rule: the first 64-bit word of ``SeedSequence([seed, sim_number,
    chunk_index, rank])``, masked to 63 bits. Rank 0 takes ``chunk_seed``
    itself (the same entropy without the trailing 0, which NumPy pads with
    zeros anyway wherever the values fit its four-word pool), so a world of
    one rank draws the single-rank run's keys.
    """
    if rank == 0:
        return chunk_seed(simulation_seed, sim_number, chunk_index)
    ss = np.random.SeedSequence([int(simulation_seed), int(sim_number),
                                 int(chunk_index), int(rank)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generate_keys(
    generator: torch.Generator, batch: int, num_bits: int, device
) -> torch.Tensor:
    """Alice's keys: uniform bits, shape [batch, num_bits] int8."""
    return torch.randint(0, 2, (batch, num_bits), generator=generator,
                         dtype=torch.int8, device=device)


def random_bits(
    generator: torch.Generator, batch: int, num_bits: int, device
) -> torch.Tensor:
    """Uniform 32-bit values per position, held in int64: the random input
    of ``inject_errors``."""
    return torch.randint(0, 1 << 32, (batch, num_bits), generator=generator,
                         dtype=torch.int64, device=device)


# The span of each launch of the select kernel (``counts.SPAN_FAMILIES``
# says why its plain version records none), and the counters of its
# launches (``count_launch("inject")``) and of the plain version's calls
# (``count_plain(device, "inject")``).
INJECT_SPAN = kernel_span("select", "inject")
INJECT_COUNTS = KernelCounts()


def _launch_select(words: torch.Tensor, alice: torch.Tensor,
                   num_errors: int, narrow: bool) -> torch.Tensor:
    bob = torch.empty_like(alice)
    raise_on_error(kernels.library().inject_select(
        words.data_ptr(), alice.data_ptr(), bob.data_ptr(), alice.shape[0],
        alice.shape[1], num_errors, int(narrow), stream_of(alice)),
        "inject_select")
    return bob


# The select kernel launches inside a registered operator, so that a
# profiler links the kernel's device time to a host operator (the trace's
# ``External id``), as it does for every torch operator: a ``ctypes`` call
# alone is none, and a span is not one either. A plain ``Library``
# definition: ``torch.library.custom_op`` would import ``torch._dynamo`` at
# its first call, seconds of set-up.
_LIBRARY = torch.library.Library("qkd_ldpc_v_tpu_torch", "DEF")
_LIBRARY.define("inject_select(Tensor words, Tensor alice, int num_errors, "
                "bool narrow) -> Tensor")
_LIBRARY.impl("inject_select", _launch_select, "CUDA")
_SELECT = torch.ops.qkd_ldpc_v_tpu_torch.inject_select.default


def inject_errors(
    rand_bits: torch.Tensor, alice: torch.Tensor, num_errors: int, wide: bool
) -> torch.Tensor:
    """Bob's keys: flip exactly ``num_errors`` distinct positions per frame.

    ``rand_bits`` [B, N] holds uniform 32-bit values (0 .. 2**32-1) in an
    integer dtype. Sort keys are random high bits with the position in the
    low bits, so all keys are distinct and the flip count is exact; the
    flipped positions are those with the ``num_errors`` smallest keys.

    ``wide`` selects the key width, as JAX selects it by its x64 flag:
      * True: 64-bit keys, the 32 random bits above a 32-bit position. JAX
        forms them unsigned; torch sorts signed int64, so the high word is
        offset by -2**31, which keeps the order and fits int64.
      * False: 32-bit keys, the random bits with their low
        ``ceil(log2 N)`` bits replaced by the position.

    Routing is by ``alice``'s device: CPU tensors run the plain version
    (``plain_inject_errors``), CUDA tensors launch the select kernel
    (``csrc/inject.cu``) on Alice's int8 key, and any other device raises.
    """
    n = alice.shape[1]
    if tuple(rand_bits.shape) != tuple(alice.shape):
        raise ValueError(f"rand_bits {tuple(rand_bits.shape)} and alice "
                         f"{tuple(alice.shape)} differ in shape")
    if not 0 <= num_errors <= n:
        raise ValueError(f"num_errors = {num_errors} is outside 0 .. {n}")
    if alice.device.type == "cpu":
        return plain_inject_errors(rand_bits, alice, num_errors, wide)
    if alice.device.type != "cuda":
        raise NotImplementedError(
            f"inject_errors: no kernel for device {alice.device}")
    if alice.dtype != torch.int8:
        raise TypeError(f"alice: expected torch.int8, got {alice.dtype}")
    if rand_bits.device != alice.device:
        raise ValueError(f"rand_bits on {rand_bits.device}, alice on "
                         f"{alice.device}")
    words = rand_bits.to(torch.int64).contiguous()
    alice = alice.contiguous()
    if alice.numel() == 0:
        return torch.empty_like(alice)
    with span(INJECT_SPAN):
        bob = _SELECT(words, alice, int(num_errors), not wide)
        INJECT_COUNTS.count_launch("inject")
    return bob


def plain_inject_errors(
    rand_bits: torch.Tensor, alice: torch.Tensor, num_errors: int, wide: bool
) -> torch.Tensor:
    """The plain version of ``inject_errors`` on any device: the sort keys
    as int64, ``torch.kthvalue`` and a compare. What the select kernel is
    held to; counted in ``INJECT_COUNTS``."""
    INJECT_COUNTS.count_plain(alice.device, "inject")
    n = alice.shape[1]
    if num_errors <= 0:
        return alice.clone()
    bits = rand_bits.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=alice.device)[None, :]
    if wide:
        keys = ((bits - (1 << 31)) << 32) | pos
    else:
        idx_bits = max(1, (n - 1).bit_length())
        keys = ((bits >> idx_bits) << idx_bits) | pos
    kth = torch.kthvalue(keys, num_errors, dim=1).values
    flips = (keys <= kth[:, None]).to(torch.int8)
    return alice ^ flips


def mc_channel_from_bits(alice_bits: torch.Tensor, error_bits: torch.Tensor,
                         num_errors: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mc channel's rule on given random words (the JAX mc kernels'
    prologue, ``ops/pallas_qc.py:316-349``): Alice's bit is bit 0 of her
    word; Bob's key flips the ``num_errors`` positions with the smallest
    32-bit sort keys ``(word >> idx_bits << idx_bits) | p``, and nothing
    where ``num_errors`` is 0. ``alice_bits`` and ``error_bits`` [B, N] hold
    32-bit values in an integer dtype; returns ``(alice, bob)`` int8."""
    alice = (alice_bits.to(torch.int64) & 1).to(torch.int8)
    return alice, inject_errors(error_bits, alice, num_errors, wide=False)


def mc_channel(seed: int, frame0: int, frames: int, n: int, num_errors: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys of the kernels' mc mode, ``(alice, bob)`` [frames, n] int8,
    for frames ``frame0 .. frame0 + frames - 1`` of the chunk whose seed is
    ``seed`` (``chunk_seed``): ``mc_channel_from_bits`` on the Philox streams
    of ``ops/philox.py``. The mc kernels draw the same bits in the kernel."""
    if not 0 <= num_errors <= n:
        raise ValueError(f"num_errors = {num_errors} is outside 0 .. {n}")
    words = [stream_words(seed, frame0, frames, n, stream, device)
             for stream in (ALICE, ERRORS)]
    return mc_channel_from_bits(*words, num_errors)


def llr_from_bits(bits: torch.Tensor, qber: float,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Channel LLRs: +/- log((1-q)/q) by Bob's bit value (reference:
    src/qkd_ldpc_algorithm.cpp:1043-1049). The log is taken in double
    precision of the double ratio and rounded to ``dtype``, as the JAX
    package's ``llr_from_bits`` does with 64-bit floats enabled."""
    log_p = torch.tensor(math.log((1.0 - qber) / qber), dtype=dtype,
                         device=bits.device)
    return torch.where(bits == 1, -log_p, log_p)


def build_frames(alice: torch.Tensor, bob: torch.Tensor,
                 alice_punct: torch.Tensor, is_payload: torch.Tensor,
                 is_punct: torch.Tensor, payload_gather: torch.Tensor,
                 log_p: float, dtype: torch.dtype = torch.float32):
    """Rate-adapted frames ``(alice_frame [B,N] int8, llr [B,N] dtype)``
    (reference: src/qkd_ldpc_algorithm.cpp:1121-1258; the JAX sweep's
    rate-adaptive ``base_step``).

    ``alice`` and ``bob`` [B, N] are the full-length keys, Bob's with the
    errors injected over all N bits; frame position i carries payload key
    bit ``payload_gather[i]`` where ``is_payload`` [N], so the payload is
    the first n key bits and the errors inside it vary from frame to frame.
    Alice's punctured bits come from ``alice_punct`` [B, N] (a fair draw);
    shortened bits are 0 in both frames. The LLR is +-``log_p`` on the
    payload (Bob's bit 1 -> negative), ``ALMOST_ZERO`` on punctured bits and
    the largest finite value of ``dtype`` on shortened bits.
    """
    dev = alice.device
    zero = torch.zeros((), dtype=torch.int8, device=dev)
    a_payload = alice.index_select(1, payload_gather)
    b_payload = bob.index_select(1, payload_gather)
    alice_frame = torch.where(is_payload, a_payload,
                              torch.where(is_punct, alice_punct, zero))
    bob_frame = torch.where(is_payload, b_payload, zero)
    lp = torch.tensor(log_p, dtype=dtype, device=dev)
    payload_llr = torch.where(bob_frame == 1, -lp, lp)
    llr = torch.where(
        is_payload, payload_llr,
        torch.where(is_punct, torch.tensor(ALMOST_ZERO, dtype=dtype, device=dev),
                    torch.tensor(torch.finfo(dtype).max, dtype=dtype,
                                 device=dev)))
    return alice_frame.to(torch.int8).contiguous(), llr.contiguous()


def syndrome_internal(layout: EdgeLayout, bits_int: torch.Tensor) -> torch.Tensor:
    """Syndrome in internal (degree-sorted) check order: bits_int [B, N] in
    internal bit order -> [B, M] int8."""
    edge_bit = layout_tensor(layout, "check_edge_bit", bits_int.device)
    edges = bits_int.to(torch.int32).index_select(1, edge_bit)
    parts = []
    for g in layout.check_groups:
        size = g.count * g.degree
        grp = edges[:, g.edge_offset:g.edge_offset + size].reshape(
            bits_int.shape[0], g.count, g.degree)
        parts.append(grp.sum(dim=-1) & 1)
    return torch.cat(parts, dim=1).to(torch.int8)


def calculate_syndrome(layout: EdgeLayout, bits_ext: torch.Tensor) -> torch.Tensor:
    """Syndrome [B, M] int8 in external check order of keys [B, N] in
    external bit order (reference: src/array_and_matrix_operations.cpp:
    936-950)."""
    dev = bits_ext.device
    bits_int = bits_ext.index_select(1, layout_tensor(layout, "bit_order", dev))
    syn_int = syndrome_internal(layout, bits_int)
    return syn_int.index_select(1, layout_tensor(layout, "check_inv", dev))


_LAYOUT_TENSORS = PlanCache()


def layout_tensor(layout: EdgeLayout, name: str, device) -> torch.Tensor:
    """One index table of ``layout`` as an int64 tensor on ``device``,
    made once per (layout, table, device)."""
    key = (name, str(torch.device(device)))
    t = _LAYOUT_TENSORS.get(layout, extra=key)
    if t is None:
        t = torch.as_tensor(np.asarray(getattr(layout, name), dtype=np.int64),
                            device=device)
        _LAYOUT_TENSORS.put(layout, t, extra=key)
    return t


def qc_syndrome(qc: QCMatrix, bits: torch.Tensor) -> torch.Tensor:
    """Syndrome [B, M] int8 of keys [B, N] (0/1) under a QC code: check
    ``(r, z)`` is the parity of bits ``(c, (z + s) mod Z)`` over the block
    edges ``(r, c, s)`` (reference: src/array_and_matrix_operations.cpp:
    936-950)."""
    z = qc.lifting
    batch = bits.shape[0]
    out = torch.zeros((batch, qc.num_check_nodes), dtype=torch.int8,
                      device=bits.device)
    for r, c, s in qc.block_edges:
        block = bits[:, c * z:(c + 1) * z].to(torch.int8)
        out[:, r * z:(r + 1) * z] ^= torch.roll(block, -s, dims=1)
    return out
