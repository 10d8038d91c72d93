"""Inputs of the exact error injection (``channel.inject_errors``) and the
flips the rule gives them, shared by the CPU tests of its plain version
(``test_torch_channel.py``), the card tests of its select kernel
(``test_torch_inject.py``) and ``chip_smoke.py``.

The rule, in NumPy (``expected_flips``): in each frame the ``num_errors``
positions first in the order of (hi, position), where hi is the word (wide
keys) or the word shifted right by ``b = max(1, bit_length(N - 1))``
(narrow keys). The word kinds are hard for a selection by high bits:
uniform words, equal words, words whose top 12 bits agree (one bin of the
kernel's first histogram), and words of four values at the edges of the
unsigned order (0, 2**31 - 1, 2**31, 2**32 - 1).
"""

import numpy as np

KINDS = ("uniform", "equal", "one_bin", "edges")
# 1000 is a multiple of 4 (the kernel's vector path); 4099 is neither that
# nor a power of two, and more equal keys than the kernel's candidate list.
SIZES = (1000, 4099)
# Which error counts of a frame of n bits: none, one, a third, all but one,
# all.
COUNTS = ("none", "one", "third", "all_but_one", "all")


def error_count(which: str, n: int) -> int:
    return {"none": 0, "one": 1, "third": n // 3, "all_but_one": n - 1,
            "all": n}[which]


def words(kind: str, batch: int, n: int, seed: int) -> np.ndarray:
    """[batch, n] int64 words in 0 .. 2**32 - 1 of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 1 << 32, (batch, n), dtype=np.int64)
    if kind == "equal":
        return np.full((batch, n), 0x9E3779B9, dtype=np.int64)
    if kind == "one_bin":
        return 0xABC00000 + rng.integers(0, 1 << 20, (batch, n),
                                         dtype=np.int64)
    if kind == "edges":
        values = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.int64)
        return rng.choice(values, (batch, n))
    raise ValueError(f"unknown kind {kind!r}")


def expected_flips(words: np.ndarray, num_errors: int,
                   wide: bool) -> np.ndarray:
    """[batch, n] int8: 1 at the ``num_errors`` positions of each frame
    whose (hi, position) come first."""
    n = words.shape[1]
    hi = words if wide else words >> max(1, (n - 1).bit_length())
    pos = np.arange(n)
    out = np.zeros(words.shape, dtype=np.int8)
    for row, frame in enumerate(hi):
        out[row, np.lexsort((pos, frame))[:num_errors]] = 1
    return out
