"""The card a run measures: the check that one is there, and what every
result states about it."""

from __future__ import annotations

import subprocess
from typing import Dict


class NoCard(RuntimeError):
    """The run asks for more cards than this machine shows."""


def require(torch, chips: int) -> None:
    """Raise unless CUDA is available with at least ``chips`` cards. A
    measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no card to measure")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoCard(f"the cell asks for {chips} cards, this machine has {have}")


def power_line() -> str:
    """``name, power.limit`` of each card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def device(torch, chips: int) -> Dict:
    """The result's ``device`` object, less the traced readings."""
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
    }
