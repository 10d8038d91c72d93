"""Piecewise-linear tanh/atanh approximations for the SPA-LIN-APPROX decoder.

Counterpart of ``qkd_ldpc_v_tpu/ops/linapprox.py`` on tensors: the same
segment boundaries and coefficients as the reference
(src/qkd_ldpc_algorithm.cpp:146-172), evaluated as a chain of
``torch.where`` selects folded from the last segment backward, so the
first true bound wins, like the reference's if/else ladder. Each segment
is ``a * |x| + b`` in the tensor's dtype, the same operations JAX runs.
"""

from __future__ import annotations

import torch

_TANH_BOUNDS = (0.5, 0.9, 1.2, 1.75, 2.5, 3.5, 8.0)
_TANH_COEFFS = (
    (0.9242, 0.0),
    (0.6355, 0.1444),
    (0.3912, 0.3642),
    (0.1958, 0.5986),
    (0.0603, 0.8358),
    (0.0115, 0.9577),
    (0.0004, 0.9967),
)

_ATANH_BOUNDS = (0.7, 0.9, 0.999)
_ATANH_COEFFS = (
    (1.196, -0.0323),
    (2.9187, -1.214),
    (10.8717, -8.3717),
    (2510.9, -2505.9),
)


def guard_atanh_ratio(ratio: torch.Tensor) -> torch.Tensor:
    """Keep the true-SPA exclusion ratio ``prod / tanh_i`` inside atanh's
    open domain in the reduced-precision modes (float32/bfloat16): clamp to
    the largest value below one and turn NaN ratios (0/0) into zero. The
    float64 path never applies it (see the JAX package's
    ``linapprox.guard_atanh_ratio`` for the measurement behind it)."""
    info = torch.finfo(ratio.dtype)
    # finfo.epsneg = 2**-(mantissa bits + 1) = eps / 2.
    limit = 1.0 - info.eps / 2
    out = torch.clamp(ratio, -limit, limit)
    return torch.where(torch.isnan(ratio), torch.zeros_like(ratio), out)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _piecewise(ax, bounds, vals, default):
    """First-true-wins where-chain: fold from the last segment backward."""
    res = default
    for b, v in zip(reversed(bounds), reversed(vals)):
        res = torch.where(ax < _scalar(b, ax), v, res)
    return res


def _segment(ax, a, b):
    return _scalar(a, ax) * ax + _scalar(b, ax)


def tanh_lin_approx(x: torch.Tensor) -> torch.Tensor:
    """8-segment tanh approximation (|x| >= 8 saturates to 1)."""
    ax = x.abs()
    vals = [_segment(ax, a, b) for a, b in _TANH_COEFFS]
    res = _piecewise(ax, _TANH_BOUNDS, vals, torch.ones_like(ax))
    return torch.where(x < 0, -res, res)


def atanh_lin_approx(x: torch.Tensor) -> torch.Tensor:
    """4-segment atanh approximation (last segment extrapolates linearly)."""
    ax = x.abs()
    vals = [_segment(ax, a, b) for a, b in _ATANH_COEFFS[:-1]]
    a_last, b_last = _ATANH_COEFFS[-1]
    res = _piecewise(ax, _ATANH_BOUNDS, vals, _segment(ax, a_last, b_last))
    return torch.where(x < 0, -res, res)
