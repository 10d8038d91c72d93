"""Batched generic LDPC syndrome decoder in plain torch.

Counterpart of ``qkd_ldpc_v_tpu/ops/decoders.py``: all six reference
algorithms (reference: src/qkd_ldpc_algorithm.cpp:3-1029) on the
degree-grouped edge layout (``models/layout.py``), batched over frames in
the same **batch-minor** orientation: message state is ``[E, B]``, each
degree group's check or bit pass is a contiguous row slice viewed as
``[count, degree, B]`` with the reduction over the middle axis, and the
regroup between the check-major and bit-major enumerations is one row
gather per direction.

Per iteration: the check pass per degree group, the clamp, one row gather
to bit-major order, the bit pass per degree group (totals, decisions, new
messages, the clamp), one row gather back, then the per-frame convergence
masks: frames whose decision syndrome matches freeze their decisions and
record the first-success iteration. The loop stops when every frame has
converged or at the cap.

Exact reference semantics, in every dtype: decisions ``total <= 0 -> 1``;
two-minimum ties give ``min2 == min1``; the parity counts ``m < 0`` while
the exclusion sign treats 0 as negative; OMSA clamps at zero after the
offset; the adaptive pair takes its per-check factor from the *previous*
decisions and detects convergence there; the message clamp applies to the
check-to-bit messages and to the new bit-to-check messages.

Association: bit totals are llr-first sequential sums in slot order, and
the SPA row product is sequential from the syndrome sign in slot order, in
every dtype: the order of every Pallas kernel and of the CUDA kernels held
to this decoder. The float64 decoder therefore equals
``qkd_ldpc_v_tpu/oracle.py`` and the JAX float64 decoder bit for bit, and
the float32 min-sum family equals the JAX float32 decoder exactly. The
JAX XLA decoder forms the float32 SPA row product with ``jnp.prod``, whose
association differs, and XLA's float32 tanh is its own approximation, so
float32 SPA agrees with it to a tolerance class. bfloat16 runs with the
same code.

This decoder is the ``xla`` engine of ``simulation.py`` and the plain
version that the fused generic kernel (``ops/fused_generic.py``) is held
to.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.layout import EdgeLayout
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome, layout_tensor
from qkd_ldpc_v_tpu_torch.ops.linapprox import (
    atanh_lin_approx,
    guard_atanh_ratio,
    tanh_lin_approx,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


class DecodeResult(NamedTuple):
    """Per-frame outcome of a batched decode."""

    decision: torch.Tensor  # [B, N] int8, external bit order
    syndromes_match: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32 (first-success iteration, or the cap)


def _group_views(flat: torch.Tensor, groups):
    """Yield (group, [count, degree, B]) contiguous views of a flat [E, B]."""
    b = flat.shape[-1]
    for g in groups:
        size = g.count * g.degree
        yield g, flat[g.edge_offset:g.edge_offset + size].view(g.count, g.degree, b)


def _sum_terms(init: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """init [c,B] + terms [c,d,B] summed over the degree axis in slot order,
    starting from init (std::accumulate from the channel LLR, reference
    :78) — the one association every engine of both packages uses."""
    acc = init
    for s in range(terms.shape[1]):
        acc = acc + terms[:, s, :]
    return acc


def _prod_terms(init: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """init [c,B] times terms [c,d,B] over the degree axis in slot order,
    starting from init (reference :57-62) — the order of every Pallas
    kernel's SPA row product, which the CUDA kernels keep."""
    acc = init
    for s in range(terms.shape[1]):
        acc = acc * terms[:, s, :]
    return acc


def _two_minimum(a: torch.Tensor, big: torch.Tensor):
    """min1, min2, is_min over the degree axis with the reference's
    sequential tie semantics: a tie at the minimum makes min2 == min1
    (reference :381-397)."""
    min1 = a.amin(dim=1)
    is_min = a == min1[:, None, :]
    count_min = is_min.sum(dim=1)
    min2_raw = torch.where(is_min, big, a).amin(dim=1)
    min2 = torch.where(count_min >= 2, min1, min2_raw)
    return min1, min2, is_min


def _minsum_check_stats(msgs: torch.Tensor, syn_sign: torch.Tensor, big, one):
    """msgs [c,d,B], syn_sign [c,B] -> (row_sign [c,B], excl_sign [c,d,B],
    eabs [c,d,B])."""
    a = msgs.abs()
    min1, min2, is_min = _two_minimum(a, big)
    neg = (msgs < 0).sum(dim=1)
    row_sign = syn_sign * torch.where(neg % 2 == 0, one, -one)
    excl_sign = torch.where(msgs > 0, one, -one)
    eabs = torch.where(is_min, min2[:, None, :], min1[:, None, :])
    return row_sign, excl_sign, eabs


def _minsum_values(msgs: torch.Tensor, syn_sign: torch.Tensor, f,
                   normalized: bool, big, one) -> torch.Tensor:
    """The min-sum check update, unclamped: msgs [c,d,B], syn_sign [c,B]
    and the factor f (a scalar, or [c,1,B] per check) -> check->bit values
    [c,d,B]; NMSA/ANMSA scale, OMSA/AOMSA offset and clamp at zero."""
    row_sign, excl_sign, eabs = _minsum_check_stats(msgs, syn_sign, big, one)
    if normalized:
        return f * row_sign[:, None, :] * excl_sign * eabs
    return row_sign[:, None, :] * excl_sign * torch.clamp(eabs - f, min=0.0)


def check_row_edges(layout: EdgeLayout, lo: int, hi: int) -> Tuple[int, int]:
    """The check-major edge range ``[e0, e1)`` of the internal checks
    ``lo .. hi - 1``."""
    def first_edge(c):
        for g in layout.check_groups:
            if c < g.node_start + g.count:
                return g.edge_offset + (c - g.node_start) * g.degree
        return layout.num_edges
    return first_edge(lo), first_edge(hi)


def _row_groups(layout: EdgeLayout, lo: int, hi: int):
    """The check groups cut to the internal checks ``lo .. hi - 1``, their
    ``edge_offset`` counted from the range's first edge."""
    e0 = check_row_edges(layout, lo, hi)[0]
    out = []
    for g in layout.check_groups:
        a = max(lo, g.node_start)
        b = min(hi, g.node_start + g.count)
        if a < b:
            out.append(dataclasses.replace(
                g, node_start=a, count=b - a,
                edge_offset=g.edge_offset + (a - g.node_start) * g.degree - e0))
    return tuple(out)


def make_decoder(
    layout: EdgeLayout,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype: torch.dtype = torch.float32,
    rows: Optional[Tuple[int, int]] = None,
    gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Callable[..., DecodeResult]:
    """Build a batched decoder for one matrix layout.

    ``decode(llr_ext [B,N], syndrome_ext [B,M] (0/1), primary, secondary,
    threshold) -> DecodeResult`` runs on the device of ``llr_ext``;
    primary/secondary are the algorithm's scaling factors (ignored by the
    SPA pair) and threshold the message clamp (used when
    ``use_threshold``).

    ``rows = (lo, hi)`` and ``gather`` make one rank's decoder of the
    edge-sharded decoder (``parallel.edge_sharded_decoder``): it keeps the
    message rows of the internal checks ``lo .. hi - 1`` alone, runs the
    check pass on them, and ``gather`` turns its check->bit rows into every
    rank's, all ``[E, B]`` in check-major order; the bit pass then runs as
    here, and the rank keeps the new bit->check messages of its rows. Each
    message is the same expression of the same values, so the decode
    equals this one bit for bit."""
    if dtype not in DTYPES:
        raise ValueError(f"generic decoder: unsupported dtype {dtype}")
    adaptive = algorithm.is_adaptive
    exact = dtype == torch.float64
    spa = algorithm in (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX)
    normalized = algorithm in (DecodingAlgorithm.NMSA, DecodingAlgorithm.ANMSA)
    check_groups = layout.check_groups
    bit_groups = layout.bit_groups
    if rows is not None:
        own_groups = _row_groups(layout, *rows)
        own_edges = slice(*check_row_edges(layout, *rows))
    else:
        own_groups, own_edges = check_groups, None
    if algorithm == DecodingAlgorithm.SPA:
        tanh_fn, atanh_fn = torch.tanh, torch.atanh
    else:
        tanh_fn, atanh_fn = tanh_lin_approx, atanh_lin_approx

    def decode(llr_ext, syndrome_ext, primary=1.0, secondary=1.0,
               threshold=0.0) -> DecodeResult:
        dev = llr_ext.device
        batch = llr_ext.shape[0]

        def table(name):
            return layout_tensor(layout, name, dev)

        def scalar(value):
            return torch.tensor(value, dtype=dtype, device=dev)

        one = scalar(1.0)
        big = scalar(torch.finfo(dtype).max)
        half = scalar(0.5)
        two = scalar(2.0)
        primary_t = scalar(primary)
        secondary_t = scalar(secondary)
        threshold_t = scalar(threshold)
        check_edge_bit = table("check_edge_bit")
        to_bit_major = table("to_bit_major")
        to_check_major = table("to_check_major")
        own_edge_bit = check_edge_bit
        if own_edges is not None:
            own_edge_bit = check_edge_bit[own_edges]
            to_check_major = to_check_major[own_edges]

        def clamp(x):
            if use_threshold:
                return torch.clamp(x, min=-threshold_t, max=threshold_t)
            return x

        def decision_syndrome(decision_int):
            """[N, B] int8 internal -> [M, B] int8 internal."""
            edges = decision_int.to(torch.int32).index_select(0, check_edge_bit)
            parts = [grp.sum(dim=1) & 1
                     for _, grp in _group_views(edges, check_groups)]
            return torch.cat(parts, dim=0).to(torch.int8)

        def check_pass(mbc, factor):
            """factor: None (use primary) or [M, B] per-check factors."""
            parts = []
            for g, msgs in _group_views(mbc, own_groups):
                ss = syn_sign[g.node_start:g.node_start + g.count]
                if spa:
                    t = tanh_fn(msgs * half)
                    row_prod = _prod_terms(ss, t)
                    ratio = row_prod[:, None, :] / t
                    if algorithm == DecodingAlgorithm.SPA and not exact:
                        ratio = guard_atanh_ratio(ratio)
                    e = two * atanh_fn(ratio)
                else:
                    if factor is None:
                        f = primary_t
                    else:
                        f = factor[g.node_start:g.node_start + g.count][:, None, :]
                    e = _minsum_values(msgs, ss, f, normalized, big, one)
                parts.append(e.reshape(-1, batch))
            return torch.cat(parts, dim=0) if parts else mbc[:0]

        def bit_pass(ecb_cm):
            """-> (decision [N,B] int8, new bit-to-check messages [E,B],
            the rank's rows where the decoder is sharded)."""
            if gather is not None:
                ecb_cm = gather(ecb_cm)
            ecb_bm = ecb_cm.index_select(0, to_bit_major)
            totals, new_parts = [], []
            for g, e in _group_views(ecb_bm, bit_groups):
                total_g = _sum_terms(llr_int[g.node_start:g.node_start + g.count], e)
                totals.append(total_g)
                new_parts.append((total_g[:, None, :] - e).reshape(-1, batch))
            decision = (torch.cat(totals, dim=0) <= 0).to(torch.int8)
            mb_bm = clamp(torch.cat(new_parts, dim=0))
            return decision, mb_bm.index_select(0, to_check_major)

        # External [B, *] -> internal batch-minor [*, B].
        llr_int = llr_ext.to(dtype).index_select(1, table("bit_order")).t().contiguous()
        syndrome_int = syndrome_ext.to(torch.int8).index_select(
            1, table("check_order")).t().contiguous()
        syn_sign = torch.where(syndrome_int == 1, -one, one)

        # Initial bit-to-check messages: the channel LLR of the edge's bit
        # (reference :21-29).
        mbc = llr_int.index_select(0, own_edge_bit)
        decision = (llr_int <= 0).to(torch.int8)
        converged = torch.zeros(batch, dtype=torch.bool, device=dev)
        iters = torch.full((batch,), max_iterations, dtype=torch.int32, device=dev)
        frozen = decision.clone()

        def note(dsyn, dec, it):
            nonlocal converged, iters, frozen
            ok = (dsyn == syndrome_int).all(dim=0)
            newly = ok & ~converged
            iters = torch.where(newly, torch.full_like(iters, it + 1), iters)
            frozen = torch.where(newly[None, :], dec, frozen)
            converged = converged | ok

        for it in range(max_iterations):
            if bool(converged.all()):
                break
            if adaptive:
                # Convergence from the *previous* decisions, detected inside
                # the check pass; the same mismatch picks the factor
                # (reference :745-776).
                dsyn = decision_syndrome(decision)
                note(dsyn, decision, it)
                factor = torch.where(dsyn != syndrome_int, secondary_t, primary_t)
                decision, mbc = bit_pass(clamp(check_pass(mbc, factor)))
            else:
                decision, mbc = bit_pass(clamp(check_pass(mbc, None)))
                note(decision_syndrome(decision), decision, it)

        final = torch.where(converged[None, :], frozen, decision)
        decision_ext = final.t().index_select(1, table("bit_inv")).contiguous()
        return DecodeResult(decision_ext, converged, iters)

    return decode


_DECODERS = PlanCache()


def get_decoder(
    layout: EdgeLayout,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype: torch.dtype = torch.float32,
) -> Callable[..., DecodeResult]:
    """Memoized ``make_decoder`` (keyed by layout identity and settings)."""
    key = (algorithm, max_iterations, use_threshold, dtype)
    fn = _DECODERS.get(layout, extra=key)
    if fn is None:
        fn = make_decoder(layout, algorithm, max_iterations, use_threshold, dtype)
        _DECODERS.put(layout, fn, extra=key)
    return fn


def frame_trial(decode: Callable[..., DecodeResult],
                syndrome_of: Callable) -> Callable:
    """A trial of prebuilt frames through a decode function, as the JAX
    sweep's ``decode_tail`` runs it: ``trial(alice_frame [B,N] int8, llr
    [B,N], primary, secondary, threshold) -> (syndromes_match, keys_match,
    iterations)``. Alice's syndrome is ``syndrome_of(alice_frame)``; keys
    match where every decision equals Alice's frame bit."""

    def trial(alice_frame, llr, primary=1.0, secondary=1.0, threshold=0.0):
        res = decode(llr, syndrome_of(alice_frame), primary, secondary,
                     threshold)
        keys = (res.decision == alice_frame).all(dim=1)
        return res.syndromes_match, keys, res.iterations

    return trial


def make_trial(
    layout: EdgeLayout,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype: torch.dtype = torch.float32,
) -> Callable:
    """A Monte-Carlo trial through this decoder, as the JAX sweep's
    ``decode_tail`` runs it: ``trial(alice [B,N] int8, bob [B,N] int8,
    log_p, primary, secondary, threshold) -> (syndromes_match, keys_match,
    iterations)``. The LLRs are ``-log_p`` where Bob's bit is 1 and
    ``log_p`` elsewhere, in ``dtype``; Alice's syndrome comes from the
    layout; keys match where every decision equals Alice's bit."""
    tail = frame_trial(
        get_decoder(layout, algorithm, max_iterations, use_threshold, dtype),
        lambda alice: calculate_syndrome(layout, alice))

    def trial(alice, bob, log_p, primary=1.0, secondary=1.0, threshold=0.0):
        lp = torch.tensor(log_p, dtype=dtype, device=alice.device)
        return tail(alice, torch.where(bob == 1, -lp, lp), primary, secondary,
                    threshold)

    return trial
