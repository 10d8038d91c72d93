"""What decides ``correct``: the reference's answers for the work a window
sampled, and the numbers that compare the program's answers with them.

A sweep combination is every trial of one QBER point, in chunks: the
reference draws each chunk's keys again by the cell's rule, decodes them,
and gives each frame's (syndrome match, key match, iterations) and the
combination's statistics (the upstream's: the shares of frames whose
syndrome, and syndrome and key, match; the iterations of the
syndrome-matched frames: mean, population standard deviation, minimum,
maximum). A round is one call of the library on 1024 frames: the
reference builds the rate-adapted frames, decodes them, and gives each
frame's outcome and the keys left after bit removal.

Numbers (each a share, so a run's size does not move it):
  * ``frame_mismatch``: frames whose (syndrome match, key match,
    iterations) differ from the reference's, over the frames compared;
  * ``stats_gap``: the largest gap between a combination's statistics and
    the reference's, each over ``max(|reference|, 1)``;
  * ``key_mismatch``: a round's frames whose output keys (Alice's or Bob's,
    after bit removal) differ from the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from benchmark.reference import channel
from benchmark.reference.decoder import Graph, decode

STATS = ("ratio_dec", "ratio_ldpc", "iter_mean", "iter_std", "iter_min",
         "iter_max")


class Outcome(NamedTuple):
    converged: np.ndarray  # bool
    keys: np.ndarray  # bool
    iterations: np.ndarray  # int


def statistics(o: Outcome) -> Dict[str, float]:
    ok = o.converged.astype(bool)
    trials = len(ok)
    out = {"ratio_dec": ok.sum() / trials,
           "ratio_ldpc": (ok & o.keys.astype(bool)).sum() / trials}
    it = o.iterations[ok].astype(np.float64)
    if len(it):
        out.update(iter_mean=it.mean(), iter_std=it.std(),
                   iter_min=it.min(), iter_max=it.max())
    else:
        out.update(iter_mean=0.0, iter_std=0.0, iter_min=0.0, iter_max=0.0)
    return {k: float(v) for k, v in out.items()}


def stats_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1.0) for k in STATS)


def mismatched(got: Outcome, want: Outcome) -> int:
    differ = ((got.converged.astype(bool) != want.converged.astype(bool))
              | (got.keys.astype(bool) != want.keys.astype(bool))
              | (got.iterations.astype(np.int64)
                 != want.iterations.astype(np.int64)))
    return int(differ.sum())


def _decode_blocks(graph: Graph, alice, bob, magnitude, dtype, algorithm,
                   primary, secondary, cap, block):
    conv, keys, iters = [], [], []
    for b0 in range(0, alice.shape[0], block):
        a = alice[b0:b0 + block]
        llr = channel.llr(bob[b0:b0 + block], magnitude, dtype)
        res = decode(graph, llr, graph.syndrome(a), algorithm, primary,
                     secondary, cap)
        conv.append(res.converged)
        keys.append((res.decision == a).all(dim=1))
        iters.append(res.iterations)
        del llr, res
    return (torch.cat(conv).cpu().numpy(), torch.cat(keys).cpu().numpy(),
            torch.cat(iters).cpu().numpy())


def chunk_outcome(graph: Graph, rule: str, seed_c: int, first: int,
                  count: int, draw: int, errors: int, algorithm: str,
                  primary: float, secondary: float, cap: int,
                  dtype=torch.float32, block: int = 4096):
    """(converged, keys, iterations) of frames ``first .. first + count -
    1`` of one chunk whose keys come from ``seed_c``: by ``rule`` "mc",
    each frame's keys a function of the seed and its index in the chunk;
    "generator", a torch generator's draw of ``draw`` frames (``first``
    0)."""
    dev = graph.device
    n = graph.n
    magnitude = channel.sweep_log_ratio(errors / n)
    decode_args = (magnitude, dtype, algorithm, primary, secondary, cap, block)
    if rule == "mc":
        parts = []
        for f0 in range(first, first + count, block):
            f = min(block, first + count - f0)
            alice, bob = channel.mc_keys(seed_c, f0, f, n, errors, dev)
            parts.append(_decode_blocks(graph, alice, bob, *decode_args))
            del alice, bob
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))
    if rule == "generator":
        if first:
            raise ValueError("a rank's share of generator keys is not the "
                             "single-rank draw")
        alice, bob = channel.generator_keys(seed_c, draw, n, errors, dev)
        return _decode_blocks(graph, alice[:count], bob[:count], *decode_args)
    raise ValueError(f"unknown key rule {rule!r}")


def sweep_combination(graph: Graph, rule: str, seed: int, number: int,
                      qber: float, trials: int, chunk: int, algorithm: str,
                      primary: float, secondary: float, cap: int,
                      dtype=torch.float32, block: int = 4096,
                      frames=None) -> Outcome:
    """The reference's outcome of every trial of combination ``number``
    (``rule``: "mc", keys drawn as the mc mode draws them, or "generator",
    a torch generator per chunk). ``frames = (first, count)`` keeps frames
    ``first .. first + count - 1`` of every chunk (one rank's share of an
    mc sweep)."""
    errors = channel.error_count(graph.n, qber)
    first, count = frames if frames is not None else (0, chunk)
    parts = []
    done, c = 0, 0
    while done < trials:
        take = min(chunk, trials - done)
        stop = min(first + count, take)
        if stop > first:
            parts.append(chunk_outcome(
                graph, rule, channel.chunk_seed(seed, number, c), first,
                stop - first, chunk, errors, algorithm, primary, secondary,
                cap, dtype, block))
        done += take
        c += 1
    return Outcome(*(np.concatenate([p[i] for p in parts]) for i in range(3)))


def round_frames(n: int, point, alice_key, bob_key, alice_punct,
                 qber: float, dtype):
    """(Alice's frame [B, N] int8, the LLRs [B, N]) of one rate-adapted
    round: the payload positions carry the keys in order, the punctured
    ones Alice's random bits (LLR 1e-4), the shortened ones 0 (the dtype's
    largest LLR)."""
    dev = alice_key.device
    b = alice_key.shape[0]
    payload = torch.as_tensor(point.payload(n), device=dev)
    punct = torch.as_tensor(point.punctured, device=dev)
    short = torch.as_tensor(point.shortened, device=dev)
    frame = torch.zeros((b, n), dtype=torch.int8, device=dev)
    frame[:, payload] = alice_key
    frame[:, punct] = alice_punct
    llr = torch.zeros((b, n), dtype=dtype, device=dev)
    llr[:, payload] = channel.llr(bob_key, channel.round_log_ratio(qber), dtype)
    llr[:, punct] = 1e-4
    llr[:, short] = torch.finfo(dtype).max
    return frame, llr


def round_reference(graph: Graph, point, alice_key, bob_key, alice_punct,
                    qber: float, algorithm: str, primary: float,
                    secondary: float, cap: int, dtype=torch.float32):
    """(Outcome, Alice's kept bits, Bob's kept bits) of one round."""
    frame, llr = round_frames(graph.n, point, alice_key, bob_key,
                              alice_punct, qber, dtype)
    res = decode(graph, llr, graph.syndrome(frame), algorithm, primary,
                 secondary, cap)
    keep = torch.as_tensor(point.keep(graph.n), device=frame.device)
    outcome = Outcome(res.converged.cpu().numpy(),
                      (res.decision == frame).all(dim=1).cpu().numpy(),
                      res.iterations.cpu().numpy())
    return outcome, frame.index_select(1, keep), res.decision.index_select(1, keep)


def key_rows_differ(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    if got.shape != want.shape:
        return np.ones(want.shape[0], dtype=bool)
    return (got.to(want.device) != want).any(dim=1).cpu().numpy()

