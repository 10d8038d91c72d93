"""The port's matrix readers and writers (qkd_ldpc_v_tpu_torch/models/
hmatrix.py) against the JAX package's.

  * Every committed asset under sparse_matrices/matrices_{alist,1,2,
    uncompressed} reads to the same bit_nodes, check_nodes and is_regular.
  * The Johnson textbook matrix (uncompressed) reads identically.
  * Every rejection case of tests/test_matrix_io.py raises the same error
    class with the same message in both packages.
  * The writers write the same bytes and round-trip.
"""

from pathlib import Path

import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import MatrixFormat as JFormat
from qkd_ldpc_v_tpu.models import hmatrix as jh
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc as jgen
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.models import hmatrix as th
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc as tgen

REPO = Path(__file__).resolve().parent.parent
FORMATS = (JFormat.ALIST, JFormat.SPARSE_1, JFormat.SPARSE_2,
           JFormat.UNCOMPRESSED)
ASSETS = sorted(
    (path, fmt)
    for fmt in FORMATS
    for path in (REPO / "sparse_matrices" / fmt.directory_name).glob("*.mtrx")
)


def assert_same_matrix(t, j):
    assert t.num_bit_nodes == j.num_bit_nodes
    assert t.num_check_nodes == j.num_check_nodes
    assert t.num_edges == j.num_edges
    assert t.is_regular == j.is_regular
    for side in ("check_nodes", "bit_nodes"):
        tr, jr = getattr(t, side), getattr(j, side)
        assert [len(r) for r in tr] == [len(r) for r in jr]
        flat = np.concatenate(tr)
        assert flat.dtype == np.int32
        np.testing.assert_array_equal(flat, np.concatenate(jr))


@pytest.mark.parametrize("path,fmt", ASSETS,
                         ids=[f"{f.name}-{p.stem}" for p, f in ASSETS])
def test_committed_assets_read_identically(path, fmt):
    j = jh.read_matrix(path, fmt)
    t = th.read_matrix(path, TFormat(int(fmt)))
    assert_same_matrix(t, j)
    assert t.source_path == Path(path)
    if t.num_edges <= 50_000:  # a set of every edge: seconds at N=102400
        t.validate_consistency()


def test_johnson_uncompressed_asset():
    path = (REPO / "sparse_matrices" / "matrices_uncompressed"
            / "(N=6,K=2,M=4,R=0.34).mtrx")
    dense = np.array([[1, 1, 0, 1, 0, 0], [0, 1, 1, 0, 1, 0],
                      [1, 0, 0, 0, 1, 1], [0, 0, 1, 1, 0, 1]], dtype=np.int8)
    t = th.read_sparse_uncompressed_matrix(path)
    np.testing.assert_array_equal(t.to_dense(), dense)
    assert_same_matrix(th.from_dense(dense), jh.from_dense(dense))
    assert_same_matrix(t, jh.read_sparse_uncompressed_matrix(path))


REJECTIONS = [
    ("read_sparse_uncompressed_matrix", "1 2\n0 1\n", "0 or 1"),
    ("read_sparse_uncompressed_matrix", "1 1 0\n0 1\n", "Different lengths"),
    ("read_sparse_uncompressed_matrix", "1 0\n1 0\n", "Column '2' weight"),
    ("read_sparse_uncompressed_matrix", "1 1\n0 0\n", "Row '2' weight"),
    ("read_sparse_uncompressed_matrix", "  \n", "empty"),
    ("read_sparse_matrix_alist", "2 1\n1 2\n2 1\n2\n1 0\n1 0\n1 2\n",
     "non-zero elements"),
    ("read_sparse_matrix_alist", "2 1\n1 2\n", "Insufficient data"),
    ("read_sparse_matrix_alist", "2 1 0\n1 2\n1 1\n2\n1\n1\n1 2\n", "Wrong sparse"),
    ("read_sparse_matrix_alist", "3 1\n1 2\n1 1\n2\n1\n1\n1 2\n",
     "Number of columns"),
    ("read_sparse_matrix_1", "4\n2\n2\n1 2 3\n3 4 0\n", "exceeded the maximum"),
    ("read_sparse_matrix_1", "4\n2\n3\n1 2\n3 4\n", "None of the row weights"),
    ("read_sparse_matrix_1", "4\n2\n3\n1 -2 3\n3 4 0\n", "less than zero"),
    ("read_sparse_matrix_1", "4 2\n2\n3\n1 2 3\n3 4 0\n", "Wrong sparse"),
    ("read_sparse_matrix_2", "4 2\n0 -1 2\n2 3\n0\n0\n0 1\n1\n", "less than zero"),
    ("read_sparse_matrix_2", "4 2\n0 1 2\n", "Insufficient data"),
    ("read_sparse_matrix_2", "4 2\n0 1 x\n2 3\n0\n0\n0 1\n1\n", "parsing"),
]


@pytest.mark.parametrize("reader,text,match", REJECTIONS)
def test_rejections_match_jax(tmp_path, reader, text, match):
    path = tmp_path / "bad.mtrx"
    path.write_text(text)
    with pytest.raises(jh.MatrixFormatError) as jerr:
        getattr(jh, reader)(path)
    with pytest.raises(th.MatrixFormatError, match=match) as terr:
        getattr(th, reader)(path)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("writer,reader", [
    ("write_alist", "read_sparse_matrix_alist"),
    ("write_sparse_1", "read_sparse_matrix_1"),
    ("write_sparse_2", "read_sparse_matrix_2"),
    ("write_dense", "read_sparse_uncompressed_matrix"),
])
def test_writers_match_jax_and_round_trip(tmp_path, writer, reader):
    j = jgen(num_bits=96, num_checks=48, column_weight=3, seed=7)
    t = tgen(num_bits=96, num_checks=48, column_weight=3, seed=7)
    assert_same_matrix(t, j)
    getattr(jh, writer)(j, tmp_path / "j.mtrx")
    getattr(th, writer)(t, tmp_path / "t.mtrx")
    assert (tmp_path / "t.mtrx").read_bytes() == (tmp_path / "j.mtrx").read_bytes()
    back = getattr(th, reader)(tmp_path / "t.mtrx")
    for a, b in zip(back.check_nodes, t.check_nodes):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(back.bit_nodes, t.bit_nodes):
        np.testing.assert_array_equal(a, b)
    back.validate_consistency()


def test_validate_consistency_rejects_mismatched_sides():
    t = th.from_dense(np.array([[1, 1, 0], [0, 1, 1]], dtype=np.int8))
    t.bit_nodes[0] = np.array([1], dtype=np.int32)
    with pytest.raises(th.MatrixFormatError, match="different edge sets"):
        t.validate_consistency()
