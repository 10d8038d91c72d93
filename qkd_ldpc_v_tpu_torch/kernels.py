"""Build and load the hand-written CUDA kernels.

At first use, every ``csrc/*.cu`` of this package is compiled by ``nvcc``
(one compiler process per source, all started together) and linked into
one shared library with a plain C interface, which is loaded with
``ctypes``. The library lands in ``build/qkd_ldpc_v_tpu_torch/`` beside the
package (``build/`` is git-ignored), named by a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags, so a changed source or
header rebuilds and an unchanged tree loads at once.

There is no fallback: without ``nvcc`` or on a failed build this raises,
and nothing returns ``None``. Parity builds never contract to FMA and never
flush denormals (``-fmad=false``, no ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from qkd_ldpc_v_tpu_torch.utils import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "qkd_ldpc_v_tpu_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_LIBRARY: Optional[ctypes.CDLL] = None
# Seconds the last build in this process took (0.0 when the library was
# already on disk), and the compiler's resource report (-Xptxas -v).
build_seconds: Optional[float] = None
build_log: str = ""


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "qkd_ldpc_v_tpu_torch are built from source at first use"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """The library's path, named by a hash of every source and header in
    ``csrc/`` and of the flags."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqkd_kernels-{digest.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc


def _build(target: Path) -> None:
    global build_seconds, build_log
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmpdir:
        objects = [Path(tmpdir) / f"{src.stem}.o" for src in sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objects)
        ]
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            procs = list(pool.map(_run, compiles))
        # Link to a private name, then rename: concurrent builds never see
        # a half-written library.
        tmp = Path(tmpdir) / target.name
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
              *[str(o) for o in objects]])
        os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(p.stdout + p.stderr for p in procs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIBRARY, build_seconds
    if _LIBRARY is None:
        with span("kernel.library"):
            target = library_path()
            if target.exists():
                build_seconds = 0.0
            else:
                _build(target)
            _LIBRARY = ctypes.CDLL(str(target))
    return _LIBRARY
