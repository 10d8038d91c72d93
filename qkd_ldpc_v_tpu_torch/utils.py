"""Small host-side utilities.

Copies of ``PlanCache``, ``get_file_paths_in_directory`` and
``format_duration`` from ``qkd_ldpc_v_tpu/utils.py`` (importing that package
imports JAX). The JAX compilation-cache helper has no counterpart here.
``span`` names a stage of the program in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import weakref
from pathlib import Path
from typing import Any, List, Optional

import torch
from torch.profiler import record_function

# Whether a torch profiler records in this thread: one C call, looked up
# once.
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the body as the range ``name``
    (``torch.profiler.record_function``) while a torch profiler records,
    and does nothing otherwise. In the Chrome trace the range is a
    ``user_annotation`` event on the clock of the device's kernels and
    copies, and the ranges open around it are its parents. ``name`` is a
    fixed string (``layer.stage``), so a trace's times add up by name."""
    if _profiling():
        return record_function(name)
    return _OFF


class PlanCache:
    """Identity-keyed cache that does not pin its key objects.

    Entries are keyed by ``id(obj)`` plus an optional tuple and hold a
    ``weakref`` to ``obj``: they self-evict when the object is garbage
    collected, and a hit is only returned while the weakref still points at
    the *same* object (id-reuse safe)."""

    def __init__(self) -> None:
        self._data: dict = {}

    def get(self, obj: Any, extra: tuple = ()) -> Optional[Any]:
        key = (id(obj),) + extra
        entry = self._data.get(key)
        if entry is not None and entry[0]() is obj:
            return entry[1]
        return None

    def put(self, obj: Any, value: Any, extra: tuple = ()) -> None:
        key = (id(obj),) + extra
        data = self._data
        ref = weakref.ref(obj, lambda _r, _k=key: data.pop(_k, None))
        data[key] = (ref, value)


def get_file_paths_in_directory(directory, extension: str) -> List[Path]:
    """Sorted file paths with the given extension (reference:
    src/utils.cpp:20-34); raises when the directory is missing."""
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"Directory does not exist: {directory}")
    return sorted(p for p in directory.iterdir() if p.suffix == extension)


def format_duration(seconds: float) -> str:
    """``00h-00m-00s`` duration string (reference: src/main.cpp:180-183)."""
    total = int(seconds)
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}h-{m:02d}m-{s:02d}s"
