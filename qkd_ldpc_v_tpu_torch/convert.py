"""Carry state from the JAX package's objects to this package's.

There are no weights: the code, the config and the keys are the state.
Both sides of a cross-package test are built from the same plain data:

  * ``qc_from_arrays(shifts, lifting)`` — a ``QCMatrix`` from a base-graph
    shift table (-1 = no block), e.g. ``jax_qc.shifts``.
  * ``hmatrix_from_rows(check_nodes, num_bits)`` — an ``HMatrix`` from the
    check rows of any code, e.g. ``jax_matrix.check_nodes``.
  * ``config_from_dict(d)`` — a ``Config`` from ``dataclasses.asdict`` of
    the JAX package's ``Config``; enums are taken by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qkd_ldpc_v_tpu_torch.config import (
    Config,
    DecodingAlgorithm,
    MatrixFormat,
    QBERAdaptationParameters,
    RAdaptationParametersRange,
    RQBERAdaptationParametersMap,
    RQBERRange,
    RScalingFactorMap,
    ScalingFactorParams,
    ScalingFactorRange,
)
from qkd_ldpc_v_tpu_torch.models.hmatrix import (
    HMatrix,
    bit_nodes_from_check_nodes,
)
from qkd_ldpc_v_tpu_torch.models.qc import QCMatrix


def qc_from_arrays(shifts: np.ndarray, lifting: int) -> QCMatrix:
    shifts = np.array(shifts, dtype=np.int64)
    lifting = int(lifting)
    if shifts.ndim != 2:
        raise ValueError(f"shifts must be 2-D [mb, nb], got {shifts.shape}")
    if lifting <= 0 or (shifts < -1).any() or (shifts >= lifting).any():
        raise ValueError("shifts must be -1 or in [0, lifting)")
    return QCMatrix(shifts=shifts, lifting=lifting)


def hmatrix_from_rows(check_nodes, num_bits: int) -> HMatrix:
    """The code whose check row j holds the bit indices ``check_nodes[j]``
    (any order; rows are kept sorted ascending), e.g.
    ``jax_matrix.check_nodes``. Regular when every row and every column has
    one weight."""
    num_bits = int(num_bits)
    rows = [np.array(sorted(int(b) for b in row), dtype=np.int32)
            for row in check_nodes]
    for j, row in enumerate(rows):
        if len(row) and (row[0] < 0 or row[-1] >= num_bits):
            raise ValueError(f"check row {j}: bit index outside [0, {num_bits})")
        if len(np.unique(row)) != len(row):
            raise ValueError(f"check row {j}: repeated bit index")
    cols = bit_nodes_from_check_nodes(rows, num_bits)
    is_regular = (len({len(r) for r in rows}) <= 1
                  and len({len(c) for c in cols}) <= 1)
    return HMatrix(cols, rows, is_regular)


def _scaling(d) -> ScalingFactorParams:
    rng = d["range"]
    return ScalingFactorParams(
        use_range=bool(d["use_range"]),
        range=None if rng is None else ScalingFactorRange(**rng),
        maps=tuple(RScalingFactorMap(**m) for m in d["maps"]),
    )


def config_from_dict(d: dict) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown Config fields: {sorted(unknown)}")
    kw = dict(d)
    kw["decoding_algorithm"] = DecodingAlgorithm(int(d["decoding_algorithm"]))
    kw["matrix_format"] = MatrixFormat(int(d["matrix_format"]))
    kw["primary"] = _scaling(d["primary"])
    kw["secondary"] = _scaling(d["secondary"])
    kw["r_qber_ranges"] = tuple(RQBERRange(**r) for r in d["r_qber_ranges"])
    kw["r_adapt_params_ranges"] = tuple(
        RAdaptationParametersRange(**r) for r in d["r_adapt_params_ranges"])
    kw["r_qber_adapt_params_maps"] = tuple(
        RQBERAdaptationParametersMap(
            code_rate=m["code_rate"],
            params=QBERAdaptationParameters(**m["params"]),
        )
        for m in d["r_qber_adapt_params_maps"]
    )
    return Config(**kw)
