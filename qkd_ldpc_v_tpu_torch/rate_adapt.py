"""Per-combination matrix modulation parameters.

Only ``HMatrixParams`` is here, copied from ``qkd_ldpc_v_tpu/rate_adapt.py``:
the fixed-rate sweep carries an empty one per combination. The
puncturing/shortening calculator and untainted puncturing come with the
rate-adaptive port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class HMatrixParams:
    """Per-combination matrix modulation parameters
    (reference: src/array_and_matrix_operations.hpp:27-57)."""

    delta: float = 0.0
    efficiency: float = 0.0
    punctured_fraction: float = 0.0
    shortened_fraction: float = 0.0
    adapted_code_rate: float = 0.0
    punctured_bits: np.ndarray = field(default_factory=lambda: np.array([], np.int32))
    shortened_bits: np.ndarray = field(default_factory=lambda: np.array([], np.int32))
    bits_to_remove: np.ndarray = field(default_factory=lambda: np.array([], np.int32))
