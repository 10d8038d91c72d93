"""Batched QKD LDPC reconciliation rounds: the single-round library API.

Counterpart of ``qkd_ldpc_v_tpu/protocol.py``. The reference runs one
(Alice, Bob) round per thread-pool task (reference:
src/qkd_ldpc_algorithm.cpp:1031-1258); here a whole batch of frames is one
decode:

  fixed rate  (QKD_LDPC, :1031-1119):  LLR init -> Alice syndrome -> batched
      decoder -> per-frame key match -> optional privacy-maintenance gather.
  rate adaptive (QKD_LDPC_RATE_ADAPT, :1121-1258): extend n-bit keys to the
      N-bit frame (punctured positions get per-frame random bits and
      LLR=ALMOST_ZERO; shortened get 0 and +max LLR; payload gets channel
      LLRs), then decode as fixed rate and always compact out the
      punctured+shortened (+privacy) positions.

All index vectors (payload/punctured/shortened positions, keep positions)
are static per combination: computed on the host, applied as gathers on
the keys' device. Alice -> Bob "communication" is the syndrome tensor passed
into the decoder.

What a round needs that depends only on its spec and its device is a round
plan (``round_plan``), built on the spec's first round on that device and
reused by every later one: the decoder (``round_decoder(spec)``), the index
arrays and ``spec.keep`` as int64 tensors
on the device, and the LLRs of punctured and shortened bits in the spec's
dtype. The plans are held per (spec, device) by the spec's identity and
freed with the spec; ``PLAN_COUNTS`` counts their hits and misses. A spec's
index arrays are read once per device, so they must not be changed in
place after its first round there: build a new spec instead.

The round runs where its key tensors lie. The decoder is the JAX package's
choice, the generic decoder, on this port's engines (``round_decoder``):
in float32 the fused generic kernel where the generic gate holds the code,
else the streamed generic kernel where the stream gate does, else the
generic torch decoder (the gates' verdicts are kept per matrix:
``engines.verdicts``); float64 and bfloat16 always take the generic
torch decoder. QC codes take the generic kernels too, as JAX's protocol
takes its generic decoder on them. The kernels' wrappers run their plain
version (the float32 generic torch decoder) on CPU tensors and launch the
kernel on CUDA tensors, so a CPU round equals the JAX package's round.

A round is the span ``protocol.round`` (``utils.span``); its stages are
``protocol.plan`` (only where the round builds its plan: the decoder's
choice, and inside it one ``protocol.positions`` for each index array of
the spec put on the keys' device), ``protocol.frame`` (the frame and its
LLRs), ``protocol.syndrome``, ``protocol.decode`` (the decoder's call),
``protocol.compare`` (the key match) and ``protocol.remove`` (the
bit-removal gathers). A round whose plan exists opens no ``protocol.plan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.engines import DTYPES, verdicts
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout, layout_for
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome, llr_from_bits
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult, get_decoder
from qkd_ldpc_v_tpu_torch.ops.fused_generic import make_fused_generic_decoder
from qkd_ldpc_v_tpu_torch.ops.generic_stream import (
    make_generic_stream_decoder,
)
from qkd_ldpc_v_tpu_torch.privacy import bits_positions_to_remove, keep_positions
from qkd_ldpc_v_tpu_torch.rate_adapt import (
    ALMOST_ZERO,
    HMatrixParams,
    finalize_bits_to_remove,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache, span

class ProtocolResult(NamedTuple):
    """Batched analogue of the reference's ``LDPC_result``
    (src/qkd_ldpc_algorithm.hpp:16-26) plus the output keys."""

    syndromes_match: torch.Tensor  # [B] bool
    keys_match: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32
    alice_out: torch.Tensor  # [B, n_out] int8 (after bit removal, if any)
    bob_out: torch.Tensor  # [B, n_out] int8


@dataclass(frozen=True, eq=False)
class ProtocolSpec:
    """Static per-combination protocol description (eq/hash by identity:
    fields hold arrays, so value equality is neither cheap nor needed).

    ``payload_positions``/``punctured_positions``/``shortened_positions``
    are None for fixed-rate operation.
    """

    matrix: HMatrix
    algorithm: DecodingAlgorithm
    max_iterations: int
    use_threshold: bool
    privacy_maintenance: bool
    rate_adaptive: bool
    dtype: str = "float32"
    bits_to_remove: Optional[np.ndarray] = None
    payload_positions: Optional[np.ndarray] = None
    punctured_positions: Optional[np.ndarray] = None
    shortened_positions: Optional[np.ndarray] = None

    @property
    def layout(self) -> EdgeLayout:
        return layout_for(self.matrix)

    @property
    def num_frame_bits(self) -> int:
        """Frame length N seen by the decoder."""
        return self.matrix.num_bit_nodes

    @property
    def num_key_bits(self) -> int:
        """Input key length n (N minus punctured/shortened for rate adapt)."""
        if self.rate_adaptive:
            return len(self.payload_positions)
        return self.matrix.num_bit_nodes

    @property
    def keep(self) -> np.ndarray:
        remove = self.bits_to_remove
        if not self.rate_adaptive and not self.privacy_maintenance:
            remove = None
        return keep_positions(self.num_frame_bits, remove)

    @property
    def output_key_bits(self) -> int:
        return len(self.keep)


def make_protocol_spec(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    privacy_maintenance: bool,
    params: Optional[HMatrixParams] = None,
    dtype: str = "float32",
) -> ProtocolSpec:
    """Build a spec for one sweep combination."""
    rate_adaptive = params is not None and not params.is_empty
    if rate_adaptive:
        if len(params.bits_to_remove) == 0:
            # The reference removes punctured+shortened (plus privacy bits)
            # unconditionally (src/qkd_ldpc_algorithm.cpp:1218-1220); derive
            # the removal set when the caller hasn't.
            finalize_bits_to_remove(matrix, params, privacy_maintenance)
        n = matrix.num_bit_nodes
        in_frame = np.zeros(n, dtype=bool)
        in_frame[params.punctured_bits] = True
        in_frame[params.shortened_bits] = True
        payload = np.flatnonzero(~in_frame).astype(np.int32)
        return ProtocolSpec(
            matrix=matrix,
            algorithm=algorithm,
            max_iterations=max_iterations,
            use_threshold=use_threshold,
            privacy_maintenance=privacy_maintenance,
            rate_adaptive=True,
            dtype=dtype,
            bits_to_remove=params.bits_to_remove,
            payload_positions=payload,
            punctured_positions=np.asarray(params.punctured_bits, np.int32),
            shortened_positions=np.asarray(params.shortened_bits, np.int32),
        )
    bits_to_remove = params.bits_to_remove if params is not None else None
    if privacy_maintenance and (bits_to_remove is None or len(bits_to_remove) == 0):
        bits_to_remove = bits_positions_to_remove(matrix)
    return ProtocolSpec(
        matrix=matrix,
        algorithm=algorithm,
        max_iterations=max_iterations,
        use_threshold=use_threshold,
        privacy_maintenance=privacy_maintenance,
        rate_adaptive=False,
        dtype=dtype,
        bits_to_remove=bits_to_remove,
    )


def round_decoder(spec: ProtocolSpec) -> Callable[..., DecodeResult]:
    """The decoder of this spec's rounds: ``decode(llr [B,N], syndrome
    [B,M] int8, primary, secondary, threshold) -> DecodeResult``. In
    float32 the fused generic kernel's decode mode inside the generic gate,
    else the streamed generic kernel's inside the stream gate
    (``engines.verdicts``), else the generic torch decoder; float64 and
    bfloat16 take the generic torch decoder. A kernel's wrapper carries its
    plain version as ``.plain``.

    A factory: each call builds a new decoder. Rounds call it once per spec
    and device, when ``round_plan`` builds the spec's plan there, and reuse
    that decoder."""
    args = (spec.algorithm, spec.max_iterations, spec.use_threshold)
    dtype = DTYPES[spec.dtype]
    if dtype == torch.float32:
        gates = verdicts(spec.matrix)
        if gates.generic:
            return make_fused_generic_decoder(spec.matrix, *args)
        if gates.stream:
            return make_generic_stream_decoder(spec.matrix, *args)
    return get_decoder(spec.layout, *args, dtype)


class PlanCounts:
    """Hits and misses of the round plans' cache (``round_plan``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.hits = 0
        self.misses = 0


PLAN_COUNTS = PlanCounts()
_PLANS = PlanCache()


class RoundPlan(NamedTuple):
    """What the rounds of one spec on one device share: the decoder, the
    spec's index arrays as int64 tensors on the device (the three position
    arrays None at a fixed rate) and the LLRs of punctured and shortened
    bits as 0-dim tensors there in the spec's dtype."""

    decode: Callable[..., DecodeResult]
    keep: torch.Tensor
    payload: Optional[torch.Tensor]
    punctured: Optional[torch.Tensor]
    shortened: Optional[torch.Tensor]
    almost_zero: torch.Tensor
    llr_max: torch.Tensor


def _positions(positions: np.ndarray, device) -> torch.Tensor:
    """One index array of a spec as int64 on ``device``."""
    with span("protocol.positions"):
        return torch.as_tensor(positions.astype(np.int64), device=device)


def round_plan(spec: ProtocolSpec, device) -> RoundPlan:
    """The plan of ``spec``'s rounds on ``device``: built, inside the span
    ``protocol.plan``, on the first round there, and found by every later
    one."""
    device = torch.device(device)
    key = (str(device),)
    plan = _PLANS.get(spec, extra=key)
    if plan is not None:
        PLAN_COUNTS.hits += 1
        return plan
    PLAN_COUNTS.misses += 1
    with span("protocol.plan"):
        dtype = DTYPES[spec.dtype]
        payload = punct = short = None
        if spec.rate_adaptive:
            payload, punct, short = (
                _positions(p, device)
                for p in (spec.payload_positions, spec.punctured_positions,
                          spec.shortened_positions))
        plan = RoundPlan(
            decode=round_decoder(spec),
            keep=_positions(spec.keep, device),
            payload=payload,
            punctured=punct,
            shortened=short,
            almost_zero=torch.tensor(ALMOST_ZERO, dtype=dtype, device=device),
            llr_max=torch.tensor(torch.finfo(dtype).max, dtype=dtype,
                                 device=device),
        )
    _PLANS.put(spec, plan, extra=key)
    return plan


def _run_decode(spec, plan, llr, alice_frame, primary, secondary, threshold):
    """Shared tail: Alice syndrome -> decode -> key match -> bit removal."""
    with span("protocol.syndrome"):
        syndrome = calculate_syndrome(spec.layout, alice_frame)
    with span("protocol.decode"):
        res = plan.decode(llr, syndrome, primary, secondary, threshold)
    with span("protocol.compare"):
        keys_match = (res.decision == alice_frame).all(dim=1)
    with span("protocol.remove"):
        alice_out = alice_frame.index_select(1, plan.keep)
        bob_out = res.decision.index_select(1, plan.keep)
    return ProtocolResult(
        syndromes_match=res.syndromes_match,
        keys_match=keys_match,
        iterations=res.iterations,
        alice_out=alice_out,
        bob_out=bob_out,
    )


def _keys(x, device) -> torch.Tensor:
    """int8 key bits on ``device``: a tensor's own device unless given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int8).contiguous()
    return torch.as_tensor(np.asarray(x, dtype=np.int8),
                           device=device or "cuda").contiguous()


def qkd_ldpc(
    spec: ProtocolSpec,
    alice,
    bob,
    qber: float,
    primary: float = 1.0,
    secondary: float = 1.0,
    threshold: float = 0.0,
) -> ProtocolResult:
    """Fixed-rate round (reference: src/qkd_ldpc_algorithm.cpp:1031-1119).

    alice/bob: [B, N] int8 keys, tensors (the round runs on their device)
    or arrays (placed on the card); qber: the accurate QBER of the batch.
    """
    with span("protocol.round"):
        alice = _keys(alice, None)
        bob = _keys(bob, alice.device)
        plan = round_plan(spec, alice.device)
        with span("protocol.frame"):
            llr = llr_from_bits(bob, qber, DTYPES[spec.dtype])
        return _run_decode(spec, plan, llr, alice, primary, secondary,
                           threshold)


def qkd_ldpc_rate_adapt(
    spec: ProtocolSpec,
    alice_key,
    bob_key,
    qber: float,
    punct_generator: Optional[torch.Generator] = None,
    primary: float = 1.0,
    secondary: float = 1.0,
    threshold: float = 0.0,
    alice_punct=None,
) -> ProtocolResult:
    """Rate-adaptive round (reference: src/qkd_ldpc_algorithm.cpp:1121-1258).

    alice_key/bob_key: [B, n] payload keys. Alice's per-frame random
    punctured bits are ``alice_punct`` [B, num_punctured] int8 when given,
    else a fair draw from ``punct_generator`` (a ``torch.Generator`` on the
    keys' device). Only Alice's draw matters: the decoder reads the
    constant ALMOST_ZERO LLR at punctured positions and keys are compared
    against Alice's extended frame; the reference consumes Bob's draw
    solely for trace printing (:1153-1154, 1230-1231).
    """
    with span("protocol.round"):
        dtype = DTYPES[spec.dtype]
        alice_key = _keys(alice_key, None)
        dev = alice_key.device
        bob_key = _keys(bob_key, dev)
        batch = alice_key.shape[0]
        plan = round_plan(spec, dev)
        payload, punct, short = plan.payload, plan.punctured, plan.shortened
        with span("protocol.frame"):
            if alice_punct is None:
                if punct_generator is None:
                    raise ValueError("qkd_ldpc_rate_adapt needs "
                                     "punct_generator or alice_punct")
                alice_punct = torch.randint(0, 2, (batch, len(punct)),
                                            generator=punct_generator,
                                            dtype=torch.int8, device=dev)
            alice_punct = _keys(alice_punct, dev)

            n_frame = spec.num_frame_bits
            alice_ext = torch.zeros((batch, n_frame), dtype=torch.int8,
                                    device=dev)
            alice_ext[:, payload] = alice_key
            alice_ext[:, punct] = alice_punct
            # shortened positions stay 0 on both sides (reference:
            # :1158-1165)

            llr = torch.zeros((batch, n_frame), dtype=dtype, device=dev)
            llr[:, payload] = llr_from_bits(bob_key, qber, dtype)
            llr[:, punct] = plan.almost_zero
            llr[:, short] = plan.llr_max
        return _run_decode(spec, plan, llr, alice_ext, primary, secondary,
                           threshold)
