"""Philox4x32-10 in plain torch: the counter-based generator of the kernels'
Monte-Carlo (mc) mode, and the stream layout that kernel and mirror share.

Philox4x32-10 is the generator of Salmon, Moraes, Dror and Shaw, "Parallel
random numbers: as easy as 1, 2, 3" (SC 2011; the Random123 library): ten
rounds of

    (hi0, lo0) = mulhilo(0xD2511F53, c0), (hi1, lo1) = mulhilo(0xCD9E8D57, c2)
    c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)

with the key bumped by (0x9E3779B9, 0xBB67AE85) between rounds. It replaces
the TPU's hardware PRNG (``pltpu.prng_seed`` / ``prng_random_bits``), whose
bits no GPU generator reproduces. ``csrc/philox.cuh`` is the same generator
as device code; this module is its plain mirror, and the two are held equal
bit for bit on the card.

Values are 32-bit words held in int64 tensors, and ``mulhilo`` works on
16-bit limbs, so the same code runs on the CPU and on the card (torch has no
unsigned 32-bit multiply-high).

The stream layout (fixed here, so that kernel and mirror cannot drift):
  * key = (chunk seed & 0xffffffff, chunk seed >> 32), the chunk seed from
    ``channel.chunk_seed``;
  * counter = (p >> 2, frame, stream, 0), where p is a bit's external
    position (0 .. N-1) and ``frame`` the frame's index in the chunk;
  * the value of (p, frame, stream) is word ``p & 3`` of the output;
  * stream ``ALICE`` gives Alice's bits (word & 1), stream ``ERRORS`` the
    error sort keys' random bits.
So the bits depend on neither the launch's grid, block or group size nor
the engine.
"""

from __future__ import annotations

from typing import Tuple

import torch

MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
KEY_BUMPS = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
MASK32 = 0xFFFFFFFF

# Streams of the mc channel (the counter's third word).
ALICE = 0
ERRORS = 1

# Shared memory of the mc mode's selection state (csrc/philox.cuh::Selection:
# 256 bins, 512 listed keys, five words; a card test holds it equal to the
# library's).
SELECTION_BYTES = 4 * (256 + 512 + 5)


def key_of(seed: int) -> Tuple[int, int]:
    """The Philox key of a chunk seed: its low and high 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned value")
    return seed & MASK32, seed >> 32


def mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product of the constant ``a``
    and the 32-bit values ``b`` (int64), from 16-bit limbs of ``b`` so that
    no partial product leaves int64."""
    lo_part = a * (b & 0xFFFF)                  # < 2**48
    hi_part = a * (b >> 16)                     # < 2**48
    low_sum = lo_part + ((hi_part & 0xFFFF) << 16)  # < 2**49
    return (hi_part >> 16) + (low_sum >> 32), low_sum & MASK32


def philox4x32(counter, key: Tuple[int, int]):
    """Philox4x32-10 of the counters ``counter = (c0, c1, c2, c3)`` (int64
    tensors or ints of 32-bit values, broadcast together) under ``key``:
    the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + KEY_BUMPS[0]) & MASK32
            k1 = (k1 + KEY_BUMPS[1]) & MASK32
        hi0, lo0 = mulhilo(MULTIPLIERS[0], c0)
        hi1, lo1 = mulhilo(MULTIPLIERS[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def stream_words(seed: int, frame0: int, frames: int, n: int, stream: int,
                 device) -> torch.Tensor:
    """The words of ``stream`` for frames ``frame0 .. frame0 + frames - 1``
    of the chunk with this seed, at positions 0 .. n-1: [frames, n] int64
    values in 0 .. 2**32 - 1."""
    quads = -(-n // 4)
    q = torch.arange(quads, dtype=torch.int64, device=device)[None, :]
    f = torch.arange(frame0, frame0 + frames, dtype=torch.int64,
                     device=device)[:, None]
    words = torch.broadcast_tensors(*philox4x32((q, f, stream, 0),
                                                key_of(seed)))
    return torch.stack(words, dim=-1).reshape(frames, 4 * quads)[:, :n]
