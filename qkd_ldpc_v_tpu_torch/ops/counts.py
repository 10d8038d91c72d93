"""What every kernel wrapper of this package shares: its counters, the span
of each counted call, the stream it launches on and the check of a launch's
return code. The launch layer (``ops/launch.py``), the kernel modules and
``ops/channel.py``, which the launch layer imports, all take these names
from here.

Counters (``KernelCounts``): ``launches`` counts kernel launches in the
trial, frame, decode and inject modes and ``mc_launches`` those in the mc
mode; ``plain_calls`` counts plain-version calls by device type and mode,
``plain_on_cuda`` those on CUDA tensors (which only tests and the card
smoke's comparisons make) and ``plain(mode)`` those of one mode. Each
counted call is the span ``kernel.<family>.<mode>`` (``kernel_span``), with
the one exception that ``SPAN_FAMILIES`` states.
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch

# The trace names of the kernel families, by the name the wrappers give
# their kernel: each launch and each plain-version call that a
# ``KernelCounts`` counts is the span ``kernel.<family>.<mode>``. The one
# exception is the select kernel's plain version (``channel.
# plain_inject_errors``), which records no span: the mc modes' plain
# versions draw their keys through it inside their own kernel span, where
# it would read as a second counted call of theirs.
SPAN_FAMILIES = {"fused QC": "fused_qc", "streamed QC": "qc_stream",
                 "fused generic": "fused_generic",
                 "streamed generic": "generic_stream", "select": "channel"}


def kernel_span(kernel: str, mode: str) -> str:
    """The span name of ``kernel``'s launches and plain calls in ``mode``."""
    return f"kernel.{SPAN_FAMILIES[kernel]}.{mode}"


class KernelCounts:
    """One kernel's counters: launches of the kernel in the trial, frame,
    decode and inject modes (``launches``) and in the mc mode
    (``mc_launches``), and calls of its plain version keyed by ``(device
    type, mode)`` (``plain_calls``), from which ``plain_on_cuda`` and
    ``plain`` read."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.mc_launches = 0
        self.plain_calls = Counter()

    @property
    def plain_on_cuda(self) -> int:
        """Plain-version calls on CUDA tensors."""
        return sum(n for (device, _), n in self.plain_calls.items()
                   if device == "cuda")

    def plain(self, mode: str) -> int:
        """Plain-version calls of ``mode`` on any device."""
        return sum(n for (_, m), n in self.plain_calls.items() if m == mode)

    def get(self) -> Tuple[int, int]:
        """(kernel launches outside the mc mode, plain-version calls on CUDA
        tensors)."""
        return self.launches, self.plain_on_cuda

    def count_launch(self, mode: str) -> None:
        if mode == "mc":
            self.mc_launches += 1
        else:
            self.launches += 1

    def count_plain(self, device: torch.device, mode: str) -> None:
        self.plain_calls[device.type, mode] += 1


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, where a launch goes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(code: int, what: str) -> None:
    """Raises for a launch that returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
