"""A plain min-sum syndrome decoder in torch, written from the upstream's
description of its four min-sum algorithms (flooding schedule), for the
reference and its control.

Per iteration, for every check, from the bit-to-check messages m of its
bits (slot order = ascending bit index):
  * |m|'s two smallest values min1 <= min2, a tie at the minimum giving
    min2 = min1 (a sequential scan); each slot's excluded minimum is min2
    where |m| == min1, else min1;
  * the row sign: the syndrome bit's sign (+1 for 0, -1 for 1) times
    (-1)^(count of m < 0); each slot's own sign: +1 where m > 0, else -1;
  * NMSA / ANMSA: factor * row sign * own sign * excluded minimum;
    OMSA / AOMSA: row sign * own sign * max(excluded minimum - factor, 0).
Then, for every bit, the total: its channel LLR plus its checks' messages
in ascending check order, summed one by one; the decision is
``total <= 0``; each new bit-to-check message is ``total - message``.
(No cell clamps its messages, so the reference has no clamp.)

NMSA and OMSA test convergence after each iteration's bit pass: a frame
whose decisions give its syndrome stops, with that iteration's number
(1-based) and those decisions. The adaptive pair tests it at the start of
each iteration, on the previous decisions (the channel's hard decision at
first), where it also picks each check's factor: ``secondary`` where that
check is unsatisfied, ``primary`` where it is satisfied; a frame found
converged at the start of iteration ``it`` (0-based) reports ``it + 1``,
and no test follows the last iteration. A frame that never converges
reports the cap and its last decisions.

Every step is elementwise or a gather in the tensors' own dtype, so the
decoder runs in float32 (the reference) or bfloat16 (its control). Frames
are independent, so converged frames leave the batch as they finish.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.alist import Code

NORMALIZED = {"NMSA": False, "ANMSA": True}
OFFSET = {"OMSA": False, "AOMSA": True}


class Decoded(NamedTuple):
    converged: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32
    decision: torch.Tensor  # [B, N] int8


class Graph:
    """Index tables of a code on a device: the check-major slots, padded to
    the largest row weight (pads read a dummy bit ``n``), and each bit's
    slots in ascending check order (pads read a zero at ``m * dc``)."""

    def __init__(self, code: Code, device) -> None:
        n, m = code.n, code.m
        dc = max(len(r) for r in code.rows)
        dv = max(len(c) for c in code.cols)
        row_bits = np.full((m, dc), n, dtype=np.int64)
        for j, r in enumerate(code.rows):
            row_bits[j, :len(r)] = r
        bit_slots = np.full((n, dv), m * dc, dtype=np.int64)
        for i, c in enumerate(code.cols):
            for s, j in enumerate(c):
                bit_slots[i, s] = j * dc + int(np.searchsorted(code.rows[j], i))
        self.n, self.m, self.dc, self.dv = n, m, dc, dv
        self.device = torch.device(device)
        self.row_bits = torch.as_tensor(row_bits.reshape(-1), device=device)
        self.valid = self.row_bits < n
        self.bit_slots = [torch.as_tensor(bit_slots[:, s].copy(), device=device)
                          for s in range(dv)]

    def syndrome(self, bits: torch.Tensor) -> torch.Tensor:
        """[B, N] 0/1 -> [B, M] int8."""
        ext = torch.cat([bits.to(torch.int32),
                         bits.new_zeros((bits.shape[0], 1), dtype=torch.int32)], 1)
        rows = ext.index_select(1, self.row_bits).view(-1, self.m, self.dc)
        return (rows.sum(dim=2) & 1).to(torch.int8)


def _check_pass(graph: Graph, v2c, syn_sign, factor, normalized: bool):
    dtype = v2c.dtype
    b = v2c.shape[0]
    vm = v2c.view(b, graph.m, graph.dc)
    a = vm.abs()
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=v2c.device)
    one = torch.ones((), dtype=dtype, device=v2c.device)
    min1 = a.amin(dim=2, keepdim=True)
    is_min = a == min1
    ties = is_min.sum(dim=2, keepdim=True) >= 2
    min2 = torch.where(ties, min1,
                       torch.where(is_min, big, a).amin(dim=2, keepdim=True))
    excluded = torch.where(is_min, min2, min1)
    odd = ((vm < 0).sum(dim=2, keepdim=True) % 2) == 1
    row_sign = syn_sign[:, :, None] * torch.where(odd, -one, one)
    own_sign = torch.where(vm > 0, one, -one)
    if normalized:
        c2v = factor * row_sign * own_sign * excluded
    else:
        c2v = row_sign * own_sign * torch.clamp(excluded - factor, min=0.0)
    return c2v.reshape(b, -1)


def decode(graph: Graph, llr: torch.Tensor, syndrome: torch.Tensor,
           algorithm: str, primary: float, secondary: float,
           cap: int) -> Decoded:
    """Decode frames ``llr`` [B, N] (its dtype is the decoder's) against
    ``syndrome`` [B, M] (0/1)."""
    if algorithm in NORMALIZED:
        adaptive, normalized = NORMALIZED[algorithm], True
    elif algorithm in OFFSET:
        adaptive, normalized = OFFSET[algorithm], False
    else:
        raise ValueError(f"the reference decodes the min-sum family, not "
                         f"{algorithm}")
    dev, dtype = llr.device, llr.dtype
    total_frames = llr.shape[0]
    one = torch.ones((), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    p = torch.tensor(primary, dtype=dtype, device=dev)
    s = torch.tensor(secondary, dtype=dtype, device=dev)

    def spread(values):
        """Bit values [b, N] -> their check-major slots (pads read 0)."""
        ext = torch.cat([values, values.new_zeros((values.shape[0], 1))], 1)
        return ext.index_select(1, graph.row_bits)

    out_conv = torch.zeros(total_frames, dtype=torch.bool, device=dev)
    out_iters = torch.full((total_frames,), cap, dtype=torch.int32, device=dev)
    out_dec = (llr <= 0).to(torch.int8)

    ids = torch.arange(total_frames, device=dev)
    target = syndrome.to(torch.int8)
    chan = llr
    syn_sign = torch.where(target == 1, -one, one)
    decision = out_dec.clone()
    v2c = torch.where(graph.valid, spread(chan), inf)

    def retire(done, it):
        nonlocal ids, target, chan, syn_sign, decision, v2c
        gone = ids[done]
        out_conv[gone] = True
        out_iters[gone] = it + 1
        out_dec[gone] = decision[done]
        keep = ~done
        ids, target, chan = ids[keep], target[keep], chan[keep]
        syn_sign, decision, v2c = syn_sign[keep], decision[keep], v2c[keep]

    for it in range(cap):
        if ids.numel() == 0:
            break
        factor = p
        if adaptive:
            dsyn = graph.syndrome(decision)
            unsat = dsyn != target
            done = ~unsat.any(dim=1)
            if bool(done.any()):
                retire(done, it)
                unsat = unsat[~done]
                if ids.numel() == 0:
                    break
            factor = torch.where(unsat, s, p)[:, :, None]
        c2v = _check_pass(graph, v2c, syn_sign, factor, normalized)
        c2v = torch.where(graph.valid, c2v, torch.zeros((), dtype=dtype, device=dev))
        c2v_ext = torch.cat([c2v, c2v.new_zeros((c2v.shape[0], 1))], 1)
        total = chan
        for slots in graph.bit_slots:
            total = total + c2v_ext.index_select(1, slots)
        decision = (total <= 0).to(torch.int8)
        v2c = torch.where(graph.valid, spread(total) - c2v, inf)
        if not adaptive:
            done = (graph.syndrome(decision) == target).all(dim=1)
            if bool(done.any()):
                retire(done, it)
    out_dec[ids] = decision
    return Decoded(out_conv, out_iters, out_dec)
