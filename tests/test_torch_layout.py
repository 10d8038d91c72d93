"""The port's degree-grouped edge layout (qkd_ldpc_v_tpu_torch/models/
layout.py) and code generator against the JAX package's: every array of
``compile_layout`` is equal, on two committed assets and on an irregular
code with bit degrees 2..5 (tests/test_pallas_generic.py::
irregular_matrix), and the generator makes the same code from a seed."""

from pathlib import Path

import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import MatrixFormat as JFormat
from qkd_ldpc_v_tpu.models import hmatrix as jh
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc as jgen
from qkd_ldpc_v_tpu.models.layout import compile_layout as jcompile
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.models import hmatrix as th
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc as tgen
from qkd_ldpc_v_tpu_torch.models.layout import compile_layout, layout_for

REPO = Path(__file__).resolve().parent.parent
ALIST = REPO / "sparse_matrices" / "matrices_alist"


def _irregular_dense():
    rng = np.random.default_rng(11)
    n, m = 288, 144
    dense = np.zeros((m, n), dtype=np.int8)
    for col in range(n):
        dense[rng.choice(m, size=2 + (col % 4), replace=False), col] = 1
    for row in range(m):
        if dense[row].sum() == 0:
            dense[row, rng.integers(0, n)] = 1
    return dense


def _pairs():
    yield "irregular", jh.from_dense(_irregular_dense()), th.from_dense(_irregular_dense())
    for name in ("(N=1024,M=82,R=0.92,CW=5,SEED=65)",
                 "(N=10240,M=2841,R=0.72,CW=4,SEED=66)"):
        path = ALIST / f"{name}.mtrx"
        yield name, jh.read_matrix(path, JFormat.ALIST), th.read_matrix(
            path, TFormat.ALIST)


@pytest.mark.parametrize("name,jm,tm", list(_pairs()), ids=lambda v: v if isinstance(v, str) else "")
def test_compile_layout_equals_jax(name, jm, tm):
    j, t = jcompile(jm), compile_layout(tm)
    for field in ("num_bits", "num_checks", "num_edges", "is_regular"):
        assert getattr(t, field) == getattr(j, field), field
    for field in ("bit_order", "bit_inv", "check_order", "check_inv",
                  "to_bit_major", "to_check_major", "check_edge_bit"):
        got, want = getattr(t, field), getattr(j, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    for side in ("check_groups", "bit_groups"):
        assert len(getattr(t, side)) == len(getattr(j, side))
        for tg, jg in zip(getattr(t, side), getattr(j, side)):
            assert (tg.node_start, tg.count, tg.degree, tg.edge_offset) == \
                (jg.node_start, jg.count, jg.degree, jg.edge_offset)
            np.testing.assert_array_equal(tg.neighbor, jg.neighbor)
            np.testing.assert_array_equal(tg.cross_flat, jg.cross_flat)
    if name == "irregular":
        assert [g.degree for g in t.bit_groups] == [2, 3, 4, 5]
    assert layout_for(tm) is layout_for(tm)


def test_generator_equals_jax():
    j = jgen(num_bits=512, num_checks=256, column_weight=3, seed=3)
    t = tgen(num_bits=512, num_checks=256, column_weight=3, seed=3)
    assert t.is_regular == j.is_regular
    for a, b in zip(t.check_nodes, j.check_nodes):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.bit_nodes, j.bit_nodes):
        np.testing.assert_array_equal(a, b)
