"""Rate adaptation and privacy maintenance, worked out again for the
reference from the upstream's description (QKD_LDPC_V: Elkouss et al.'s
rate modulation, arXiv:1007.1616; untainted puncturing, arXiv:1103.6149;
privacy maintenance by one used check per removed bit).

For each operating point (QBER q, delta, efficiency f) of the code's rate
bracket, in sweep order (QBER, then delta, then efficiency; ranges expand
as ``begin + i * step`` for ``i`` up to ``round((end - begin) / step)``):
  * target rate ``R_t = 1 - f * h(q)``; shortened count
    ``s = ceil((R0 - R_t (1 - delta)) N)``; punctured count
    ``p = int(delta N - s)``; a point with ``s <= 0``, ``p <= 0`` or more
    punctured bits than the untainted list holds is skipped;
  * punctured bits: the first ``p`` positions of the code's untainted list
    (the ``.untp`` file, which ``untainted_faults`` holds to the greedy),
    ascending;
  * shortened bits: the first ``s`` of ``rng.permutation`` of the other
    positions, ascending, one NumPy generator ``default_rng(seed)`` serving
    the points in order;
  * bits removed for privacy maintenance: all shortened and punctured bits
    (each punctured bit, in ascending order, marks the first unused check
    of its column), then the other bits by ascending column weight (a
    stable order) wherever their column has an unused check, which it then
    marks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

import numpy as np

from benchmark.reference.alist import Code


def expand(begin: float, end: float, step: float) -> List[float]:
    if begin == end:
        return [begin]
    return [begin + i * step for i in range(int(round((end - begin) / step)) + 1)]


def entropy(q: float) -> float:
    return -q * np.log2(q) - (1.0 - q) * np.log2(1.0 - q)


@dataclass(frozen=True)
class Point:
    qber: float
    delta: float
    efficiency: float
    punctured: np.ndarray
    shortened: np.ndarray
    removed: np.ndarray

    def payload(self, n: int) -> np.ndarray:
        mask = np.ones(n, dtype=bool)
        mask[self.punctured] = False
        mask[self.shortened] = False
        return np.flatnonzero(mask)

    def keep(self, n: int) -> np.ndarray:
        mask = np.ones(n, dtype=bool)
        mask[self.removed] = False
        return np.flatnonzero(mask)


def read_untainted(path) -> np.ndarray:
    return np.array([int(t) for t in Path(path).read_text().split()],
                    dtype=np.int64)


def untainted_faults(code: Code, listed) -> int:
    """How far ``listed`` departs from an output of the untainted greedy
    (arXiv:1103.6149: X starts as every bit; pick a bit of X with the
    fewest other bits of X that share a check with it; take it and every
    bit that shares a check with it out of X; repeat until X is empty),
    replayed on the code: picks outside X or with more such bits than the
    fewest, and bits still in X after the list (a set that is not
    maximal). 0 whatever tie-break the greedy used."""
    n = code.n
    near = []
    for i in range(n):
        bits = np.unique(np.concatenate([code.rows[j] for j in code.cols[i]]))
        near.append(bits[bits != i])
    in_x = np.ones(n, dtype=bool)
    counts = np.array([len(b) for b in near], dtype=np.int64)
    big = np.iinfo(np.int64).max
    faults = 0
    for v in (int(b) for b in listed):
        if not 0 <= v < n or not in_x[v]:
            faults += 1
            continue
        if counts[v] != np.where(in_x, counts, big).min():
            faults += 1
        leaving = np.concatenate(([v], near[v][in_x[near[v]]]))
        in_x[leaving] = False
        for u in leaving:
            counts[near[u]] -= 1
    return faults + int(in_x.sum())


def removed_bits(code: Code, punctured, shortened) -> np.ndarray:
    used = set()
    punct, short = set(int(p) for p in punctured), set(int(s) for s in shortened)
    removed, others = [], []
    for i in range(code.n):
        if i in short:
            removed.append(i)
        elif i in punct:
            removed.append(i)
            free = [int(j) for j in code.cols[i] if int(j) not in used]
            if free:
                used.add(free[0])
        else:
            others.append(i)
    others.sort(key=lambda i: len(code.cols[i]))
    for i in others:
        free = [int(j) for j in code.cols[i] if int(j) not in used]
        if free:
            removed.append(i)
            used.add(free[0])
    return np.array(sorted(removed), dtype=np.int64)


def points(code: Code, untainted: np.ndarray, seed: int,
           qbers: Sequence[float], deltas: Sequence[float],
           efficiencies: Sequence[float]) -> List[Point]:
    rng = np.random.default_rng(seed)
    n, m = code.n, code.m
    r0 = 1.0 - m / n
    out = []
    for q in qbers:
        for d in deltas:
            for f in efficiencies:
                r_t = 1.0 - f * entropy(q)
                s = int(math.ceil((r0 - r_t * (1.0 - d)) * n))
                p = int(d * n - s)
                if s <= 0 or p <= 0 or p > len(untainted):
                    continue
                punctured = np.sort(untainted[:p])
                rest = np.setdiff1d(np.arange(n), punctured)
                shortened = np.sort(rng.permutation(rest)[:s])
                out.append(Point(q, d, f, punctured, shortened,
                                 removed_bits(code, punctured, shortened)))
    return out
