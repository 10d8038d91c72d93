"""Privacy maintenance of the port (qkd_ldpc_v_tpu_torch/privacy.py)
against the JAX package, on the CPU: both greedy selections and
``keep_positions`` equal JAX's exactly on the 1k and 10k alist codes and
on a QC code, the rate-adaptive selection on real adaptation points.
"""

from pathlib import Path

import numpy as np
import pytest

from qkd_ldpc_v_tpu import privacy as jpr
from qkd_ldpc_v_tpu.config import MatrixFormat as JFormat
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu.rate_adapt import adapt_code_rate as jadapt
from qkd_ldpc_v_tpu_torch import privacy as tpr
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix

MATRICES = Path(__file__).resolve().parent.parent / "sparse_matrices"
# (path, format, an achievable (QBER, delta, efficiency) of its rate)
CODES = {
    "alist1k": (MATRICES / "matrices_alist"
                / "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx", TFormat.ALIST,
                (0.05, 0.1, 1.4)),
    "alist10k": (MATRICES / "matrices_alist"
                 / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx", TFormat.ALIST,
                 (0.034, 0.1, 1.3)),
    "qc10k": (MATRICES / "matrices_qc"
              / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx", TFormat.QC,
              (0.034, 0.1, 1.3)),
}


@pytest.fixture(scope="module", params=list(CODES))
def code(request):
    path, fmt, point = CODES[request.param]
    return (jread_matrix(path, JFormat(int(fmt))), tread_matrix(path, fmt),
            point)


def _same(got, want):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_fixed_rate_selection_equals_jax(code):
    jm, tm, _ = code
    got = tpr.bits_positions_to_remove(tm)
    _same(got, jpr.bits_positions_to_remove(jm))
    assert 0 < len(got) <= tm.num_check_nodes


def test_rate_adaptive_selection_equals_jax(code):
    jm, tm, point = code
    params = jadapt(np.random.default_rng(2), jm, *point)
    assert len(params.punctured_bits) and len(params.shortened_bits)
    got = tpr.bits_positions_to_remove_rate_adapt(
        tm, params.punctured_bits, params.shortened_bits)
    _same(got, jpr.bits_positions_to_remove_rate_adapt(
        jm, params.punctured_bits, params.shortened_bits))
    assert set(params.shortened_bits) <= set(got)
    assert set(params.punctured_bits) <= set(got)


def test_keep_positions_equals_jax(code):
    jm, tm, point = code
    n = tm.num_bit_nodes
    params = jadapt(np.random.default_rng(2), jm, *point)
    for remove in (None, np.array([], np.int32), params.shortened_bits,
                   tpr.bits_positions_to_remove(tm)):
        got = tpr.keep_positions(n, remove)
        _same(got, jpr.keep_positions(n, remove))
        removed = 0 if remove is None else len(remove)
        assert len(got) == n - removed


def test_first_available():
    for cands, used in (([3, 1, 2], {3}), ([5], {5}), ([], set()),
                        (np.array([7, 8]), {8})):
        assert tpr._first_available(cands, used) == \
            jpr._first_available(cands, used)
