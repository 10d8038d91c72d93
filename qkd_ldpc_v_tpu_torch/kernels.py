"""Build and load the hand-written CUDA kernels.

At first use, every ``csrc/*.cu`` of this package is compiled by ``nvcc``
(one compiler process per source, all started together) and linked into
one shared library with a plain C interface, which is loaded with
``ctypes``. The library lands in ``build/qkd_ldpc_v_tpu_torch/`` beside the
package (``build/`` is git-ignored), named by a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags, so a changed source or
header rebuilds and an unchanged tree loads at once. ``library()`` declares
every entry's argument and return types from one table, ``SIGNATURES``,
when it loads the library.

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
from typing import Dict, Optional, Tuple

from qkd_ldpc_v_tpu_torch.utils import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "qkd_ldpc_v_tpu_torch"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)


def _signatures() -> Dict[str, Tuple[list, type]]:
    """Every entry the library exports (the ``extern "C"`` functions of
    ``csrc/*.cu``; a CPU test holds the names to the sources) as ``name:
    (argtypes, restype)``. A decode entry takes its inputs, the code's
    shape, the mode's scalars, the kernel's launch tail, and three outputs
    and the stream."""
    p, i, f, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint, ctypes.c_longlong)
    inputs = {"trial": [p, p, i], "decode": [p, p, i], "frame": [p, p, i],
              "mc": [u, u, i, i, i]}  # (k0, k1, frame0, num_errors, batch)
    scalars = {"trial": [i, i, i, f, f, f, f], "mc": [i, i, i, f, f, f, f],
               "decode": [i, i, i, f, f, f], "frame": [i, i, i, f, f, f]}

    def launches(family, modes, shape, tail):
        return {f"{family}_{mode}": (inputs[mode] + shape + scalars[mode]
                                     + tail + [p, p, p, p], i)
                for mode in modes}

    def queries(names, nargs, restype=i):
        return {name: ([i] * nargs, restype) for name in names}

    qc_shape = [p, i, i, i, i, i]  # table, mb, nb, z, num_be, max_deg
    return {
        # csrc/fused_qc.cu; tail: slice, grid
        **launches("fused_qc", ("trial", "decode", "frame", "mc"), qc_shape,
                   [p, i]),
        **queries(("fused_qc_max_lifting", "fused_qc_max_block_edges",
                   "fused_qc_max_base_checks", "mc_selection_bytes"), 0),
        "fused_qc_threads": ([i], i),
        "fused_qc_shared_bytes": ([i] * 7, ll),
        "fused_qc_resident_blocks": ([i] * 7, i),
        # csrc/qc_stream.cu; tail: scratch, per_cluster, cluster, grid
        **launches("qc_stream", ("trial", "decode", "mc"), qc_shape,
                   [p, ll, i, i]),
        **queries(("qc_stream_max_lifting", "qc_stream_max_block_edges",
                   "qc_stream_max_base_checks", "qc_stream_max_base_bits",
                   "qc_stream_max_cluster"), 0),
        "qc_stream_threads": ([i, i], i),
        "qc_stream_shared_bytes": ([i] * 6, ll),
        "qc_stream_scratch_words": ([i] * 5, ll),
        "qc_stream_resident_clusters": ([i] * 7, i),
        # csrc/fused_generic.cu; shape: table, n, m, e, max_deg; tail:
        # slice, grid, threads
        **launches("fused_generic", ("trial", "decode", "frame", "mc"),
                   [p, i, i, i, i], [p, i, i]),
        "fused_generic_max_threads": ([], i),
        "fused_generic_shared_bytes": ([i] * 5, ll),
        "fused_generic_slice_floats": ([i] * 3, ll),
        "fused_generic_resident_blocks": ([i] * 7 + [ctypes.POINTER(i)], i),
        # csrc/generic_stream.cu; shape: table, n, m, e; tail: group,
        # scratch, grid, threads
        **launches("generic_stream", ("trial", "decode"), [p, i, i, i],
                   [i, p, i, i]),
        "generic_stream_shared_bytes": ([i] * 3, ll),
        "generic_stream_scratch_bytes": ([i] * 5, ll),
        "generic_stream_resident_blocks": ([i] * 5, i),
        # csrc/generic_cluster.cu; shape: table, n, m, e, check_groups,
        # bit_groups; tail: scratch, frames, cluster, clusters
        **launches("generic_cluster", ("trial",), [p, i, i, i, i, i],
                   [p, i, i, i]),
        **queries(("generic_cluster_max_groups", "generic_cluster_max_degree",
                   "generic_cluster_max_frames"), 0),
        "generic_cluster_threads": ([i] * 4, i),
        "generic_cluster_shared_bytes": ([i] * 4, ll),
        "generic_cluster_record_bytes": ([i] * 2, ll),
        "generic_cluster_resident": ([i] * 5, i),
        # csrc/spa.cu: x, out, n, step, stream
        "spa_steps": ([p, p, ll, i, p], i),
        # csrc/inject.cu: words, alice, bob, batch, n, num_errors, narrow,
        # stream
        "inject_select": ([p, p, p, i, i, i, i, p], i),
    }


SIGNATURES = _signatures()

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
    """The loaded kernel library, built first if needed, with every entry's
    signature (``SIGNATURES``) declared."""
    global _LIBRARY, build_seconds
    if _LIBRARY is None:
        with span("kernel.library"):
            target = library_path()
            if target.exists():
                build_seconds = 0.0
            else:
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in SIGNATURES.items():
                entry = getattr(lib, name)
                entry.argtypes, entry.restype = argtypes, restype
            _LIBRARY = lib
    return _LIBRARY
