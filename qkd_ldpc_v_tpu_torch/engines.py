"""The engine and the kernel of a code, decided once.

``select_engine`` names the engine of a (matrix, config) as the JAX
package's ``pallas_engine`` does, from copies of its gates: ``qc``
(``_qc_fused_gate``: ops/pallas_qc.py::feasible_batch_tile > 0 at its
smallest tile), ``qc_stream`` (``qc_stream_feasible``), ``generic``
(``fused_generic.generic_feasible``, which that kernel also enforces),
``stream`` (``stream_feasible``), else ``xla``; ``use_pallas = false`` or a
dtype other than float32 is ``xla``, and ``tpu.force_engine`` pins one. The
gates' byte budgets are the TPU kernels' on-chip memory and say nothing
about this port's kernels, which check their own bounds. ``verdicts``
runs the four gates once per matrix object and keeps their verdicts while
the matrix lives; the sweep and the library rounds
(``protocol.round_decoder``) read them there.

An engine runs one kernel: ``qc`` and ``qc_stream`` the QC kernel
``qc_kernel`` picks (the fused QC kernel where it holds the code, else the
streamed QC kernel), ``generic`` the fused generic kernel, ``stream`` the
streamed generic kernel and ``xla`` the generic torch decoder.
``KERNELS`` maps each kernel to its factories of the sweep's three modes,
which ``_make_trial``, ``montecarlo_trial`` and ``frame_engine_trial``
look up.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from qkd_ldpc_v_tpu_torch.config import Config
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome, qc_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import (
    frame_trial,
    get_decoder,
    make_trial,
)
from qkd_ldpc_v_tpu_torch.ops.fused_generic import (
    generic_feasible,
    make_fused_generic_frame_trial,
    make_fused_generic_montecarlo,
    make_fused_generic_trial,
)
from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
    fused_qc_fits,
    make_fused_qc_frame_trial,
    make_fused_qc_montecarlo,
    make_fused_qc_trial,
)
from qkd_ldpc_v_tpu_torch.ops.generic_stream import (
    make_generic_stream_decoder,
    make_generic_stream_trial,
)
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import MIN_SUM, base_tables
from qkd_ldpc_v_tpu_torch.ops.qc_stream import (
    make_qc_stream_decoder,
    make_qc_stream_montecarlo,
    make_qc_stream_trial,
)
from qkd_ldpc_v_tpu_torch.utils import PlanCache

# The sweep's log lines keep the logger of simulation.py.
logger = logging.getLogger("qkd_ldpc_v_tpu_torch.simulation")

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}

# The TPU lane width, by which the JAX package's kernels tile; both of its QC
# kernels' block-edge cap; the fused one's smallest batch tile, which is the
# streamed one's tile; their VMEM budgets (ops/pallas_qc.py,
# ops/pallas_qc_stream.py).
_LANES = 128
_MAX_BLOCK_EDGES = 420
_TILE = 8
_QC_BUDGET = 84 * 1024 * 1024
_QC_STREAM_BUDGET = 72 * 1024 * 1024


def _qc_fused_gate(qc: QCMatrix) -> bool:
    num_be = int((qc.shifts >= 0).sum())
    if qc.lifting % _LANES or num_be > _MAX_BLOCK_EDGES:
        return False
    nb, mb = qc.base_bits, qc.base_checks
    planes = num_be + 3 * nb + mb + 2 * nb
    return planes * qc.lifting * 4 * _TILE <= _QC_BUDGET


def qc_stream_feasible(qc: QCMatrix) -> bool:
    """The JAX package's ``qc_stream_feasible`` verdict: Z a multiple of 128,
    1-420 block edges, every base row non-empty, and the TPU kernel's
    resident planes within its VMEM budget."""
    if qc.lifting % _LANES:
        return False
    rows, _, num_be = base_tables(qc)
    if num_be == 0 or num_be > _MAX_BLOCK_EDGES:
        return False
    if any(not r for r in rows):
        return False
    max_deg = max(len(r) for r in rows)
    units = 3 * qc.base_bits + qc.base_checks + 2 * max_deg + 6
    return units * _TILE * qc.lifting * 4 <= _QC_STREAM_BUDGET


def stream_feasible(matrix: HMatrix) -> bool:
    """The JAX package's ``stream_feasible`` verdict: more than 256 edge rows
    of 128 lanes on the bit side at its widest degree, and check degrees
    under 64."""
    if not matrix.bit_nodes or not matrix.check_nodes:
        return False
    dmax_b = max(len(r) for r in matrix.bit_nodes)
    dmax_c = max(len(r) for r in matrix.check_nodes)
    return dmax_b * -(-matrix.num_bit_nodes // _LANES) > 256 and dmax_c < 64


class Verdicts(NamedTuple):
    """The four gates' verdicts on one code, by the engine each admits (the
    QC gates are False for a code without QC structure)."""

    qc: bool
    qc_stream: bool
    generic: bool
    stream: bool


_VERDICTS = PlanCache()


def verdicts(matrix: HMatrix) -> Verdicts:
    """The gates' verdicts on ``matrix``: run on its first call and kept,
    without pinning the matrix, for every later one."""
    found = _VERDICTS.get(matrix)
    if found is None:
        qc = matrix.qc
        found = Verdicts(qc is not None and _qc_fused_gate(qc),
                         qc is not None and qc_stream_feasible(qc),
                         generic_feasible(matrix), stream_feasible(matrix))
        _VERDICTS.put(matrix, found)
    return found


def select_engine(matrix: HMatrix, cfg: Config) -> str:
    """The engine for this (matrix, config): "qc" | "qc_stream" | "generic"
    | "stream" | "xla", chosen as ``qkd_ldpc_v_tpu.simulation.pallas_engine``
    chooses it. ``tpu.force_engine`` pins one; a pinned engine that cannot
    serve the matrix raises ``ValueError``."""
    if not cfg.use_pallas or cfg.dtype != "float32":
        return "xla"
    force = cfg.force_engine
    found = verdicts(matrix)
    for engine in Verdicts._fields:
        if force in ("", engine) and getattr(found, engine):
            return engine
    if force and force != "xla":
        raise ValueError(
            f"tpu.force_engine = {force!r} cannot serve this matrix"
        )
    return "xla"


def qc_kernel(qc: QCMatrix, engine: str, layered: bool) -> str:
    """The kernel a QC engine runs on this code and schedule: "fused_qc" |
    "qc_stream".

    Engine ``qc_stream`` always runs the streamed kernel; engine ``qc`` runs
    the fused kernel where ``fused_qc_fits`` says it holds the code, else
    the streamed one. Both kernels equal the same plain versions bit for
    bit, so this is a capacity choice made from the code's shape before any
    launch, and results do not depend on it."""
    if engine not in ("qc", "qc_stream"):
        raise ValueError(f"engine {engine!r} is not a QC engine")
    if engine == "qc" and fused_qc_fits(qc, layered):
        return "fused_qc"
    return "qc_stream"


# The kernel of each engine that is not a QC engine.
_ENGINE_KERNELS = {"generic": "fused_generic", "stream": "generic_stream",
                   "xla": "torch"}

# Each kernel's factories: the trial of given keys, the mc mode (None where
# the kernel has none) and the trial of prebuilt frames. A kernel without a
# frame mode gives its decoder there, which ``frame_engine_trial`` runs on
# Alice's syndrome taken in torch, as the JAX sweep's ``decode_tail`` does.
KERNELS = {
    "fused_qc": (make_fused_qc_trial, make_fused_qc_montecarlo,
                 make_fused_qc_frame_trial),
    "qc_stream": (make_qc_stream_trial, make_qc_stream_montecarlo,
                  make_qc_stream_decoder),
    "fused_generic": (make_fused_generic_trial, make_fused_generic_montecarlo,
                      make_fused_generic_frame_trial),
    "generic_stream": (make_generic_stream_trial, None,
                       make_generic_stream_decoder),
    "torch": (make_trial, None, get_decoder),
}
_FRAME_MODE = ("fused_qc", "fused_generic")
_TRIAL, _MC, _FRAME = range(3)


def _schedule(engine: str, matrix: HMatrix, cfg: Config) -> Tuple[str, bool]:
    """(kernel, layered) of this engine and config; warns where the layered
    schedule asked for cannot run (not a QC engine, or the SPA pair, as the
    JAX package's ``_effective_schedule``) and the engine floods. The QC
    kernel is chosen for the schedule that runs."""
    is_qc = engine in ("qc", "qc_stream")
    layered = (is_qc and cfg.schedule == "layered"
               and cfg.decoding_algorithm in MIN_SUM)
    if cfg.schedule == "layered" and not layered:
        logger.warning(
            "tpu.schedule = layered needs a QC engine and a min-sum "
            "algorithm; using the flooding schedule for this combination."
        )
    if not is_qc:
        return _ENGINE_KERNELS[engine], False
    kernel = qc_kernel(matrix.qc, engine, layered)
    logger.info("engine %s: the %s kernel (N=%d, Z=%d)", engine, kernel,
                matrix.num_bit_nodes, matrix.qc.lifting)
    return kernel, layered


def _made(engine: str, matrix: HMatrix, cfg: Config, mode: int):
    """(kernel, its factory of ``mode`` called on this code and config)."""
    kernel, layered = _schedule(engine, matrix, cfg)
    make = KERNELS[kernel][mode]
    args = (cfg.decoding_algorithm, cfg.decoding_alg_max_iterations,
            cfg.enable_msg_llr_threshold)
    if kernel in ("fused_qc", "qc_stream"):
        return kernel, make(matrix.qc, *args,
                            schedule="layered" if layered else "flooding")
    if kernel == "torch":
        return kernel, make(layout_for(matrix), *args, DTYPES[cfg.dtype])
    return kernel, make(matrix, *args)


def _make_trial(engine: str, matrix: HMatrix, cfg: Config) -> Callable:
    """The engine's trial of given keys: ``trial(alice, bob, log_p,
    primary, secondary, threshold) -> (syndromes_match, keys_match,
    iterations)``."""
    return _made(engine, matrix, cfg, _TRIAL)[1]


def montecarlo_trial(engine: str, matrix: HMatrix,
                     cfg: Config) -> Optional[Callable]:
    """The engine's mc mode for fixed-rate runs, or None where it has none.

    As in the JAX sweep (``_build_step``: ``mk_mc``): the fused QC kernel
    (engine ``qc`` where it holds the code), the streamed QC kernel (engine
    ``qc`` beyond it, and ``qc_stream``) and the fused generic kernel
    (``generic``) draw the keys in the kernel; ``stream`` and ``xla`` have no
    mc mode. ``mc(seed, frame0, batch, num_errors, log_p, primary,
    secondary, threshold, device) -> (syndromes_match, keys_match,
    iterations)``."""
    if engine not in ("qc", "qc_stream", "generic"):
        return None
    return _made(engine, matrix, cfg, _MC)[1]


def frame_engine_trial(engine: str, matrix: HMatrix, cfg: Config) -> Callable:
    """The rate-adaptive step's decode of prebuilt frames for this engine:
    ``trial(alice_frame [B,N] int8, llr [B,N], primary, secondary,
    threshold) -> (syndromes_match, keys_match, iterations)``.

    As in the JAX sweep (``_build_step``: ``mk_frame`` and
    ``decode_tail``): the fused QC kernel (engine ``qc`` where it holds the
    code) and the fused generic kernel run their frame mode; the streamed
    QC kernel (engine ``qc`` beyond the fused kernel, and ``qc_stream``),
    the streamed generic kernel (``stream``) and the generic torch decoder
    (``xla``) run their decode mode on Alice's syndrome taken in torch and
    compare keys over the whole frame."""
    kernel, made = _made(engine, matrix, cfg, _FRAME)
    if kernel in _FRAME_MODE:
        return made
    if kernel == "qc_stream":
        return frame_trial(made, lambda a: qc_syndrome(matrix.qc, a))
    layout = layout_for(matrix)
    return frame_trial(made, lambda a: calculate_syndrome(layout, a))
