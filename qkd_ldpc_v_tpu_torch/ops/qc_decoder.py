"""Plain torch QC-LDPC decoders.

These are the plain versions of the QC kernels (``ops/fused_qc.py``,
``csrc/fused_qc.cu``; ``ops/qc_stream.py``, ``csrc/qc_stream.cu``): the
same arithmetic, in the same f32 operation order, written as batched
tensor code. The CPU path runs them, and the kernels are held to them bit
for bit on the card.

  * ``decode_flooding`` — counterpart of ``qkd_ldpc_v_tpu/ops/
    qc_decoder.py::make_qc_decoder`` and of the TPU kernels' flooding
    schedule, for all six algorithms: the min-sum family NMSA/OMSA/ANMSA/
    AOMSA and the SPA pair (SPA, SPA-lin-approx).
  * ``decode_layered`` — a batched torch port of the layered specification
    ``_layered_oracle`` (tests/test_pallas_qc.py): block-rows in storage
    order, totals updated within the sweep, the adaptive factor taken from
    the current decisions. The min-sum family only: the SPA pair keeps the
    reference's flooding schedule, and asking for it raises ``ValueError``
    as the TPU kernels' ``_build`` does.

Circulant convention: check-aligned index z of block edge (r, c, s) is bit
(c, (z + s) mod Z), so ``roll(x, -s)`` moves a bit-aligned plane to checks
and ``roll(x, +s)`` moves it back.

Semantics kept exactly (reference: src/qkd_ldpc_algorithm.cpp:3-1029):
decisions ``total <= 0 -> 1``; the pairwise two-minimum chain with
``min2`` starting at the float32 maximum; ``excl = m > 0 ? 1 : -1``;
``row_sign`` from the syndrome sign and the parity of ``m < 0``; NMSA
``f * row_sign * excl * eabs`` and OMSA ``row_sign * excl * max(eabs - f,
0)``; the SPA pair as the TPU kernels' check pass computes it, per
block-row on the check-aligned planes in storage order: ``t_i = tanh(m_i *
0.5)`` (SPA-lin: ``ops/linapprox.py``), the sequential product ``prod = ss
* t_0 * t_1 * ...`` from the syndrome sign ``ss``, ``ratio_i = prod /
t_i``, for SPA the atanh guard (``linapprox.guard_atanh_ratio``) and then
``2 * atanh(ratio_i)``; the optional message clamp at the TPU kernel's
program points; llr-first sequential bit totals in base-row order;
per-frame early exit with the decisions of the converging iteration.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu_torch.ops.linapprox import (
    atanh_lin_approx,
    guard_atanh_ratio,
    tanh_lin_approx,
)

MIN_SUM = (
    DecodingAlgorithm.NMSA,
    DecodingAlgorithm.OMSA,
    DecodingAlgorithm.ANMSA,
    DecodingAlgorithm.AOMSA,
)


def base_tables(qc: QCMatrix):
    """rows[r] = [(be, c, s)], cols[c] = [(be, r, s)], in storage order
    (block edges numbered row by row) — the order the kernel sweeps."""
    rows = []
    cols: List[List[Tuple[int, int, int]]] = [[] for _ in range(qc.base_bits)]
    be = 0
    for r in range(qc.base_checks):
        row = []
        for c in range(qc.base_bits):
            s = int(qc.shifts[r, c])
            if s >= 0:
                row.append((be, c, s))
                cols[c].append((be, r, s))
                be += 1
        rows.append(row)
    return rows, cols, be


SPA_PAIR = (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX)


def check_layered(algorithm: DecodingAlgorithm, layered: bool) -> None:
    """Raise ``ValueError`` for the layered schedule with the SPA pair, as
    the TPU kernels' ``_build`` does: the pair floods."""
    if layered and algorithm not in MIN_SUM:
        raise ValueError(
            f"the layered schedule supports the min-sum family "
            f"(NMSA/OMSA/ANMSA/AOMSA) only, not {algorithm.display_name}")


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


class _RowUpdate:
    """The check update of one block-row, shared by both schedules (op
    order is the kernel's)."""

    def __init__(self, algorithm, use_threshold, primary, secondary,
                 threshold, device):
        self.spa = algorithm in SPA_PAIR
        self.guard = algorithm == DecodingAlgorithm.SPA
        if algorithm == DecodingAlgorithm.SPA:
            self.tanh, self.atanh = torch.tanh, torch.atanh
        else:
            self.tanh, self.atanh = tanh_lin_approx, atanh_lin_approx
        self.half = _f32(0.5, device)
        self.two = _f32(2.0, device)
        self.offset = algorithm in (DecodingAlgorithm.OMSA,
                                    DecodingAlgorithm.AOMSA)
        self.adaptive = algorithm.is_adaptive
        self.use_threshold = use_threshold
        self.primary = _f32(primary, device)
        self.secondary = _f32(secondary, device)
        self.threshold = _f32(threshold, device)
        self.big = _f32(torch.finfo(torch.float32).max, device)
        self.zero = _f32(0.0, device)

    def clamp(self, x):
        if self.use_threshold:
            return torch.clamp(x, min=-self.threshold, max=self.threshold)
        return x

    def factor(self, mismatch):
        """Per-check factor: secondary where the check is unsatisfied."""
        return torch.where(mismatch != 0, self.secondary, self.primary)

    def spa_row(self, msgs, ss):
        """The SPA pair's clamped check->bit values of one block-row. The
        elementwise steps run on the row's messages stacked, which gives
        each element the bits it would get alone; the product runs over the
        block edges in storage order."""
        ts = self.tanh(torch.stack(msgs) * self.half)
        prod = ss
        for t in ts:
            prod = prod * t
        ratio = prod / ts
        if self.guard:
            ratio = guard_atanh_ratio(ratio)
        return list(self.clamp(self.two * self.atanh(ratio)).unbind(0))

    def __call__(self, msgs, syn_bits, f):
        if self.spa:
            one = torch.ones_like(msgs[0])
            return self.spa_row(msgs, torch.where(syn_bits == 1, -one, one))
        a = [m.abs() for m in msgs]
        min1 = a[0]
        min2 = torch.full_like(min1, float(self.big))
        for ai in a[1:]:
            min2 = torch.minimum(min2, torch.maximum(min1, ai))
            min1 = torch.minimum(min1, ai)
        neg = torch.zeros(min1.shape, dtype=torch.int32, device=min1.device)
        for m in msgs:
            neg = neg + (m < 0).to(torch.int32)
        one = torch.ones_like(min1)
        ss = torch.where(syn_bits == 1, -one, one)
        row_sign = ss * torch.where(neg % 2 == 0, one, -one)
        vals = []
        for m, ai in zip(msgs, a):
            excl = torch.where(m > 0, one, -one)
            eabs = torch.where(ai == min1, min2, min1)
            if self.offset:
                val = row_sign * excl * torch.maximum(eabs - f, self.zero)
            else:
                val = f * row_sign * excl * eabs
            vals.append(self.clamp(val))
        return vals


def _mismatch(rows, dec, syn_blocks, z):
    """Per block-row [B, Z] int8: 1 where the check is unsatisfied by the
    decisions dec [B, N] int8."""
    out = []
    for r, row in enumerate(rows):
        acc = syn_blocks[r].clone()
        for (e, c, s) in row:
            acc ^= torch.roll(dec[:, c * z:(c + 1) * z], -s, dims=1)
        out.append(acc)
    return out


def _all_satisfied(mismatches):
    ok = None
    for m in mismatches:
        row_ok = (m == 0).all(dim=1)
        ok = row_ok if ok is None else ok & row_ok
    return ok


def _check_inputs(qc, llr, syndrome):
    b, n = llr.shape
    if n != qc.num_bit_nodes or syndrome.shape != (b, qc.num_check_nodes):
        raise ValueError(
            f"llr {tuple(llr.shape)} / syndrome {tuple(syndrome.shape)} do "
            f"not fit the code (N={qc.num_bit_nodes}, M={qc.num_check_nodes})"
        )
    if llr.dtype != torch.float32:
        raise ValueError("plain QC decoders are float32-only")


def decode_flooding(
    qc: QCMatrix,
    llr: torch.Tensor,
    syndrome: torch.Tensor,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    primary: float = 1.0,
    secondary: float = 1.0,
    threshold: float = 0.0,
) -> DecodeResult:
    """Flooding decode of llr [B, N] f32 against syndrome [B, M] (0/1), any
    of the six algorithms. Non-adaptive algorithms check convergence after
    each bit pass; the adaptive pair checks the previous decisions at the
    top of each iteration and picks the per-check factor from the same
    mismatch."""
    _check_inputs(qc, llr, syndrome)
    dev = llr.device
    z, nb, mb = qc.lifting, qc.base_bits, qc.base_checks
    rows, cols, num_be = base_tables(qc)
    upd = _RowUpdate(algorithm, use_threshold, primary, secondary,
                     threshold, dev)
    batch = llr.shape[0]
    llr_c = [llr[:, c * z:(c + 1) * z] for c in range(nb)]
    syn = syndrome.to(torch.int8)
    syn_blocks = [syn[:, r * z:(r + 1) * z] for r in range(mb)]

    msg = [None] * num_be
    for row in rows:
        for (e, c, s) in row:
            msg[e] = torch.roll(llr_c[c], -s, dims=1)
    dec = (llr <= 0).to(torch.int8)
    frozen = dec.clone()
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    iters = torch.full((batch,), max_iterations, dtype=torch.int32, device=dev)

    def note(ok, it):
        newly = ok & ~converged
        iters[newly] = it + 1
        frozen[newly] = dec[newly]
        converged.logical_or_(ok)

    for it in range(max_iterations):
        if bool(converged.all()):
            break
        factors = None
        if upd.adaptive:
            mism = _mismatch(rows, dec, syn_blocks, z)
            note(_all_satisfied(mism), it)
            factors = [upd.factor(m) for m in mism]
        for r, row in enumerate(rows):
            f = upd.primary if factors is None else factors[r]
            vals = upd([msg[e] for (e, _, _) in row], syn_blocks[r], f)
            for (e, _, _), v in zip(row, vals):
                msg[e] = v
        totals = []
        for c in range(nb):
            eps = [torch.roll(msg[e], s, dims=1) for (e, _, s) in cols[c]]
            total = llr_c[c]
            for ep in eps:
                total = total + ep
            totals.append(total)
            for (e, _, s), ep in zip(cols[c], eps):
                msg[e] = torch.roll(upd.clamp(total - ep), -s, dims=1)
        dec = (torch.cat(totals, dim=1) <= 0).to(torch.int8)
        if not upd.adaptive:
            note(_all_satisfied(_mismatch(rows, dec, syn_blocks, z)), it)

    final = torch.where(converged[:, None], frozen, dec)
    return DecodeResult(final, converged, iters)


def decode_layered(
    qc: QCMatrix,
    llr: torch.Tensor,
    syndrome: torch.Tensor,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    primary: float = 1.0,
    secondary: float = 1.0,
    threshold: float = 0.0,
) -> DecodeResult:
    """Layered (serial-C) min-sum decode: block-rows in storage order, each
    reading the current totals and writing ``t + (val - E)`` at once;
    convergence is checked after each sweep. The SPA pair raises
    ``ValueError``: it floods."""
    check_layered(algorithm, True)
    _check_inputs(qc, llr, syndrome)
    dev = llr.device
    z, nb, mb = qc.lifting, qc.base_bits, qc.base_checks
    rows, _, num_be = base_tables(qc)
    upd = _RowUpdate(algorithm, use_threshold, primary, secondary,
                     threshold, dev)
    batch = llr.shape[0]
    total = [llr[:, c * z:(c + 1) * z].clone() for c in range(nb)]
    syn = syndrome.to(torch.int8)
    syn_blocks = [syn[:, r * z:(r + 1) * z] for r in range(mb)]
    ext = [torch.zeros((batch, z), dtype=torch.float32, device=dev)
           for _ in range(num_be)]
    dec = (llr <= 0).to(torch.int8)
    frozen = dec.clone()
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    iters = torch.full((batch,), max_iterations, dtype=torch.int32, device=dev)

    for it in range(max_iterations):
        if bool(converged.all()):
            break
        for r, row in enumerate(rows):
            rolled = [torch.roll(total[c], -s, dims=1) for (_, c, s) in row]
            msgs = [rt - ext[e] for rt, (e, _, _) in zip(rolled, row)]
            if upd.adaptive:
                acc = syn_blocks[r].clone()
                for rt in rolled:
                    acc ^= (rt <= 0).to(torch.int8)
                f = upd.factor(acc)
            else:
                f = upd.primary
            vals = upd(msgs, syn_blocks[r], f)
            for (e, c, s), v in zip(row, vals):
                total[c] = total[c] + torch.roll(v - ext[e], s, dims=1)
                ext[e] = v
        dec = (torch.cat(total, dim=1) <= 0).to(torch.int8)
        ok = _all_satisfied(_mismatch(rows, dec, syn_blocks, z))
        newly = ok & ~converged
        iters[newly] = it + 1
        frozen[newly] = dec[newly]
        converged.logical_or_(ok)

    final = torch.where(converged[:, None], frozen, dec)
    return DecodeResult(final, converged, iters)
