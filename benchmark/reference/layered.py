"""A plain layered min-sum syndrome decoder in torch for QC codes, written
from the layered schedule's description, for the reference and its
control.

Schedule. One sweep visits the block-rows in storage order. Block-row
``r`` holds checks ``r*Z .. r*Z + Z - 1``; each bit appears in it at most
once, so its checks read and write the bit totals without conflict. For
every check of the row and every bit of it (``qc.block_row_bits``):
  * the message is ``total - E``, where E is the check's last value on
    that edge (0 before its first);
  * the check's values are the min-sum rules of ``reference/decoder.py``
    (its ``_check_pass``: the two-minimum chain with ties, the excluded
    minimum, the row sign from the syndrome bit and the parity of the
    negative messages, the own sign ``m > 0 ? 1 : -1``; NMSA / ANMSA
    ``factor * row sign * own sign * minimum``, OMSA / AOMSA ``row sign *
    own sign * max(minimum - factor, 0)``);
  * the factor is ``primary``, except in the adaptive pair, where it is
    ``secondary`` for a check whose bits' current decisions (``total <=
    0``, read before the row's update) leave it unsatisfied;
  * each bit's total becomes ``total + (value - E)``, and E becomes the
    value.
The totals start at the channel LLRs. After each sweep the decisions
``total <= 0`` are tested against the whole syndrome: a frame that
satisfies it stops, with that sweep's number (1-based) and those
decisions. A frame that never does reports the cap and its last
decisions. No message is clamped (no cell clamps).

Every step is elementwise or a gather in the tensors' own dtype, so the
decoder runs in float32 (the reference) or bfloat16 (its control). Frames
are independent, so converged frames leave the batch as they finish, and
a chunk is decoded in blocks of frames.

Keys follow the mc mode's rule (``channel.mc_keys``): bit ``c*Z + z`` of a
frame is position ``c*Z + z`` of its Philox streams.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from benchmark.reference import channel
from benchmark.reference.compare import Outcome
from benchmark.reference.decoder import NORMALIZED, OFFSET, Decoded, _check_pass
from benchmark.reference.qc import QC, block_row_bits


class Layers:
    """A QC code's block-rows on a device: each row's bits, check-major
    ([Z, d] flattened)."""

    def __init__(self, qc: QC, device) -> None:
        self.n, self.z = qc.n, qc.z
        self.device = torch.device(device)
        tables = [block_row_bits(qc, r) for r in range(qc.shifts.shape[0])]
        self.degrees: List[int] = [t.shape[1] for t in tables]
        self.rows = [torch.as_tensor(t.reshape(-1), device=device)
                     for t in tables]

    def syndrome(self, bits: torch.Tensor) -> torch.Tensor:
        """[B, N] 0/1 -> [B, M] int8."""
        b = bits.shape[0]
        wide = bits.to(torch.int32)
        return torch.cat([
            wide.index_select(1, idx).view(b, self.z, d).sum(dim=2) & 1
            for idx, d in zip(self.rows, self.degrees)], dim=1).to(torch.int8)


def decode(layers: Layers, llr: torch.Tensor, syndrome: torch.Tensor,
           algorithm: str, primary: float, secondary: float,
           cap: int) -> Decoded:
    """Decode frames ``llr`` [B, N] (its dtype is the decoder's) against
    ``syndrome`` [B, M] (0/1) in the layered schedule."""
    if algorithm in NORMALIZED:
        adaptive, normalized = NORMALIZED[algorithm], True
    elif algorithm in OFFSET:
        adaptive, normalized = OFFSET[algorithm], False
    else:
        raise ValueError(f"the layered reference decodes the min-sum "
                         f"family, not {algorithm}")
    dev, dtype = llr.device, llr.dtype
    z = layers.z
    total_frames = llr.shape[0]
    one = torch.ones((), dtype=dtype, device=dev)
    p = torch.tensor(primary, dtype=dtype, device=dev)
    s = torch.tensor(secondary, dtype=dtype, device=dev)

    out_conv = torch.zeros(total_frames, dtype=torch.bool, device=dev)
    out_iters = torch.full((total_frames,), cap, dtype=torch.int32, device=dev)
    out_dec = (llr <= 0).to(torch.int8)

    ids = torch.arange(total_frames, device=dev)
    target = syndrome.to(torch.int8)
    syn_sign = torch.where(target == 1, -one, one)
    total = llr.clone()
    decision = out_dec.clone()
    ext = [torch.zeros((total_frames, idx.numel()), dtype=dtype, device=dev)
           for idx in layers.rows]
    checks = [SimpleNamespace(m=z, dc=d) for d in layers.degrees]

    for it in range(cap):
        if ids.numel() == 0:
            break
        b = ids.numel()
        for r, idx in enumerate(layers.rows):
            rows = slice(r * z, (r + 1) * z)
            t = total.index_select(1, idx)
            factor = p
            if adaptive:
                parity = (t <= 0).view(b, z, -1).sum(dim=2) & 1
                factor = torch.where(parity != target[:, rows], s, p)[:, :, None]
            value = _check_pass(checks[r], t - ext[r], syn_sign[:, rows],
                                factor, normalized)
            total.index_copy_(1, idx, t + (value - ext[r]))
            ext[r] = value
        decision = (total <= 0).to(torch.int8)
        done = (layers.syndrome(decision) == target).all(dim=1)
        if bool(done.any()):
            gone = ids[done]
            out_conv[gone] = True
            out_iters[gone] = it + 1
            out_dec[gone] = decision[done]
            keep = ~done
            ids, target, syn_sign = ids[keep], target[keep], syn_sign[keep]
            total, decision = total[keep], decision[keep]
            ext = [e[keep] for e in ext]
    out_dec[ids] = decision
    return Decoded(out_conv, out_iters, out_dec)


def chunk_outcome(layers: Layers, seed_c: int, first: int, count: int,
                  errors: int, algorithm: str, primary: float,
                  secondary: float, cap: int, dtype=torch.float32,
                  block: int = 8192):
    """(converged, keys, iterations) of frames ``first .. first + count -
    1`` of the mc chunk whose seed is ``seed_c``, decoded in blocks of
    ``block`` frames."""
    dev = layers.device
    magnitude = channel.sweep_log_ratio(errors / layers.n)
    parts = []
    for f0 in range(first, first + count, block):
        f = min(block, first + count - f0)
        alice, bob = channel.mc_keys(seed_c, f0, f, layers.n, errors, dev)
        res = decode(layers, channel.llr(bob, magnitude, dtype),
                     layers.syndrome(alice), algorithm, primary, secondary,
                     cap)
        parts.append((res.converged.cpu().numpy(),
                      (res.decision == alice).all(dim=1).cpu().numpy(),
                      res.iterations.cpu().numpy()))
        del alice, bob, res
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def sweep_combination(layers: Layers, seed: int, number: int, qber: float,
                      trials: int, chunk: int, algorithm: str,
                      primary: float, secondary: float, cap: int,
                      dtype=torch.float32, block: int = 8192) -> Outcome:
    """The reference's outcome of every trial of combination ``number``,
    its keys drawn as the mc mode draws them, chunk by chunk."""
    errors = channel.error_count(layers.n, qber)
    parts = []
    done, c = 0, 0
    while done < trials:
        take = min(chunk, trials - done)
        parts.append(chunk_outcome(
            layers, channel.chunk_seed(seed, number, c), 0, take, errors,
            algorithm, primary, secondary, cap, dtype, block))
        done += take
        c += 1
    return Outcome(*(np.concatenate([p[i] for p in parts]) for i in range(3)))
