"""The SPA pair's elementwise steps alone: the test entry of the CUDA
kernels' shared SPA code (``csrc/spa.cuh``, entry ``csrc/spa.cu``) and its
plain torch version.

The four decode kernels compute the SPA pair's check update with the device
functions of ``csrc/spa.cuh``; ``spa_steps`` applies two of them to a
tensor, so that they can be held bit for bit against torch on every float32
input (``chip_smoke.py``, phase 2g) apart from any decode. No decoder calls
it. The steps (``STEPS``):

  * ``tanh``: ``tanh(x * 0.5)``, the term of a bit->check message (SPA);
  * ``atanh``: ``2 * atanh(guard_atanh_ratio(x))``, the check->bit value of
    an exclusion ratio (SPA);
  * ``tanh_lin`` and ``atanh_lin``: the same with the SPA-lin-approx tables
    of ``ops/linapprox.py`` and no guard.

Routing is by the tensor's device: CPU tensors take the plain version, CUDA
tensors launch the entry, and any other device raises.
"""

from __future__ import annotations

import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.ops.counts import (
    KernelCounts,
    raise_on_error,
    stream_of,
)
from qkd_ldpc_v_tpu_torch.ops.linapprox import (
    atanh_lin_approx,
    guard_atanh_ratio,
    tanh_lin_approx,
)
from qkd_ldpc_v_tpu_torch.utils import span

STEPS = ("tanh", "atanh", "tanh_lin", "atanh_lin")
# The span of each step's launches and plain calls.
SPANS = {step: f"kernel.spa.{step}" for step in STEPS}

COUNTS = KernelCounts()


def plain_step(x: torch.Tensor, step: str) -> torch.Tensor:
    """The plain torch version of one step, as ``ops/qc_decoder.py`` and
    ``ops/decoders.py`` compute it in float32."""
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    two = torch.tensor(2.0, dtype=x.dtype, device=x.device)
    if step == "tanh":
        return torch.tanh(x * half)
    if step == "atanh":
        return two * torch.atanh(guard_atanh_ratio(x))
    if step == "tanh_lin":
        return tanh_lin_approx(x * half)
    if step == "atanh_lin":
        return two * atanh_lin_approx(x)
    raise ValueError(f"unknown step {step!r}; expected one of {STEPS}")


def spa_step(x: torch.Tensor, step: str) -> torch.Tensor:
    """``step`` of ``STEPS`` applied to a contiguous float32 tensor: the
    kernel entry on CUDA, the plain version on the CPU."""
    if step not in STEPS:
        raise ValueError(f"unknown step {step!r}; expected one of {STEPS}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("spa_step takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        with span(SPANS[step]):
            COUNTS.count_plain(x.device, step)
            return plain_step(x, step)
    if x.device.type != "cuda":
        raise NotImplementedError(f"spa_step: no kernel for device {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with span(SPANS[step]):
        raise_on_error(kernels.library().spa_steps(
            x.data_ptr(), out.data_ptr(), x.numel(), STEPS.index(step),
            stream_of(x)), f"spa_steps {step}")
        COUNTS.count_launch(step)
    return out
