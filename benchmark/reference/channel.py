"""The channel as the benchmark's cells state it, worked out again for the
reference: which keys each chunk decodes, and their LLRs.

Rules (the upstream's exact-count channel: Bob's key is Alice's with
exactly floor(N * QBER) errors at distinct uniform positions):
  * ``chunk_seed``: the seed of one chunk of one combination, the first
    64-bit word of NumPy's ``SeedSequence([seed, combination, chunk])``
    masked to 63 bits;
  * mc mode (keys drawn in the kernel): Alice's bit is bit 0 of her Philox
    word; the errors sit at the ``num_errors`` smallest 32-bit sort keys
    ``(word >> b << b) | p``, ``b = max(1, bit_length(N - 1))``;
  * torch-generator keys (engines without an mc mode): one
    ``torch.Generator`` on the card per chunk, seeded with the chunk seed,
    draws Alice's bits (``randint(0, 2)``, int8) and then one 32-bit value
    per position (``randint(0, 2**32)``, int64); the errors sit at the
    ``num_errors`` smallest 64-bit keys ``(value - 2**31) << 32 | p``;
  * the sweep's LLR magnitude ``log((1 - q) / q)`` at the accurate QBER
    ``q = num_errors / N``: the ratio in float32, its log in double
    precision rounded to float32; a round's, at the QBER it is given, in
    double precision rounded to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import philox


def error_count(n: int, qber: float) -> int:
    return int(n * qber)


def chunk_seed(seed: int, combination: int, chunk: int) -> int:
    ss = np.random.SeedSequence([int(seed), int(combination), int(chunk)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def _flip_smallest(keys: torch.Tensor, alice: torch.Tensor,
                   num_errors: int) -> torch.Tensor:
    if num_errors <= 0:
        return alice.clone()
    kth = torch.kthvalue(keys, num_errors, dim=1).values
    return alice ^ (keys <= kth[:, None]).to(torch.int8)


def mc_keys(seed: int, frame0: int, frames: int, n: int, num_errors: int,
            device):
    """(alice, bob) [frames, n] int8 of the mc mode's frames ``frame0 ..``
    of the chunk with this seed."""
    words = philox.stream_words(seed, frame0, frames, n, philox.ALICE, device)
    alice = (words & 1).to(torch.int8)
    del words
    errs = philox.stream_words(seed, frame0, frames, n, philox.ERRORS, device)
    b = max(1, (n - 1).bit_length())
    pos = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    keys = ((errs >> b) << b) | pos
    del errs
    return alice, _flip_smallest(keys, alice, num_errors)


def generator_keys(seed: int, frames: int, n: int, num_errors: int, device):
    """(alice, bob) [frames, n] int8 of a chunk whose keys come from a
    torch generator seeded with ``seed`` (the whole chunk: the draw
    depends on its shape)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    alice = torch.randint(0, 2, (frames, n), generator=gen, dtype=torch.int8,
                          device=device)
    values = torch.randint(0, 1 << 32, (frames, n), generator=gen,
                           dtype=torch.int64, device=device)
    pos = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    keys = ((values - (1 << 31)) << 32) | pos
    del values
    return alice, _flip_smallest(keys, alice, num_errors)


def sweep_log_ratio(qber: float) -> float:
    q = np.float32(qber)
    ratio = np.float32(np.float32(1.0) - q) / q
    return float(np.float32(math.log(float(ratio))))


def round_log_ratio(qber: float) -> float:
    return float(np.float32(math.log((1.0 - qber) / qber)))


def llr(bob: torch.Tensor, magnitude: float, dtype) -> torch.Tensor:
    lp = torch.tensor(magnitude, dtype=dtype, device=bob.device)
    return torch.where(bob == 1, -lp, lp)
