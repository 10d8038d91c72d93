"""Decoder result type.

Only ``DecodeResult`` is ported so far (``qkd_ldpc_v_tpu/ops/decoders.py``);
the generic torch decoder for arbitrary sparse H is a later step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DecodeResult(NamedTuple):
    """Per-frame outcome of a batched decode."""

    decision: torch.Tensor  # [B, N] int8, external bit order
    syndromes_match: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32 (first-success iteration, or the cap)
