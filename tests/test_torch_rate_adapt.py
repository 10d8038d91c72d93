"""Code-rate adaptation of the port (qkd_ldpc_v_tpu_torch/rate_adapt.py) and
the rate-adaptive sweep (simulation.prepare_sim_inputs) against the JAX
package, on the CPU. Every comparison is exact.

  * ``adapt_code_rate``: punctured and shortened positions, fractions,
    adapted rate and the skips, with random and untainted puncturing.
  * ``second_order_csr``, the untainted greedy for one seed on a 1k code,
    and ``get_punctured_bits_untainted``: a committed ``.untp`` is read as
    JAX reads it, and a missing one is written with the same bytes and
    leaves the generator in the same state.
  * ``prepare_sim_inputs`` gives JAX's combinations on CPU-sized variants
    of configs/example_rate_adapt.json, configs/campaign_fec_measurement.json
    and configs/campaign_adaptive_aomsa.json (their 1k matrices).
  * The committed ``.untp`` caches: each that scripts/make_assets.py drew
    regenerates byte for byte from its seed; each of the seven that hold
    another draw is a maximal untainted set, and from the same seed the JAX
    package's greedy gives the port's positions, not the cache.
"""

import dataclasses
import functools
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from qkd_ldpc_v_tpu import rate_adapt as jra
from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import MatrixFormat as JFormat
from qkd_ldpc_v_tpu.config import parse_config_data as jparse
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu_torch import rate_adapt as tra
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.config import parse_config_data as tparse
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix

REPO = Path(__file__).resolve().parent.parent
MATRICES = REPO / "sparse_matrices"
ALIST_1K = MATRICES / "matrices_alist" / "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx"
QC_1K = MATRICES / "matrices_qc" / "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx"
PARAM_FIELDS = ("delta", "efficiency", "punctured_fraction",
                "shortened_fraction", "adapted_code_rate")


def _both(path, fmt):
    return jread_matrix(path, JFormat(int(fmt))), tread_matrix(path, fmt)


@pytest.fixture(scope="module")
def codes():
    return {"alist": _both(ALIST_1K, TFormat.ALIST),
            "qc": _both(QC_1K, TFormat.QC)}


def assert_params_equal(t, j):
    for name in PARAM_FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    for name in ("punctured_bits", "shortened_bits", "bits_to_remove"):
        got, want = np.asarray(getattr(t, name)), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert t.is_empty == j.is_empty


def test_binary_entropy():
    for q in (0.001, 0.0238, 0.05, 0.11, 0.5):
        assert tra.binary_entropy(q) == jra.binary_entropy(q)


# (QBER, delta, efficiency): achievable points and skips on both sides of
# the range (R0 = 0.625 for both 1k codes).
POINTS = [(0.05, 0.1, 1.4), (0.05, 0.1, 1.2), (0.04, 0.05, 1.3),
          (0.03, 0.1, 1.1), (0.0519, 0.1, 1.12), (0.05, 0.1, 1.5),
          (0.08, 0.1, 1.1)]


@pytest.mark.parametrize("kind", ["alist", "qc"])
@pytest.mark.parametrize("untainted", [False, True])
def test_adapt_code_rate_equals_jax(codes, kind, untainted):
    jm, tm = codes[kind]
    path = ALIST_1K if kind == "alist" else QC_1K
    if untainted:
        jm.punctured_bits_untainted = jra.get_punctured_bits_untainted(
            path, np.random.default_rng(0), jm)
        tm.punctured_bits_untainted = tra.get_punctured_bits_untainted(
            path, np.random.default_rng(0), tm)
    jrng, trng = np.random.default_rng(21), np.random.default_rng(21)
    skipped = 0
    for point in POINTS:
        want = jra.adapt_code_rate(jrng, jm, *point, use_untainted=untainted)
        got = tra.adapt_code_rate(trng, tm, *point, use_untainted=untainted)
        assert_params_equal(got, want)
        skipped += got.is_empty
        for privacy in (False, True):
            jra.finalize_bits_to_remove(jm, want, privacy)
            tra.finalize_bits_to_remove(tm, got, privacy)
            assert_params_equal(got, want)
    assert 0 < skipped < len(POINTS)
    assert trng.integers(0, 1 << 62) == jrng.integers(0, 1 << 62)


def test_untainted_without_pool_raises(codes):
    _, tm = codes["alist"]
    tm.punctured_bits_untainted = None
    with pytest.raises(ValueError, match="untainted"):
        tra.adapt_code_rate(np.random.default_rng(0), tm, 0.05, 0.1, 1.4,
                            use_untainted=True)


@pytest.mark.parametrize("kind", ["alist", "qc"])
def test_second_order_csr_equals_jax(codes, kind):
    jm, tm = codes[kind]
    jflat, joff = jra.second_order_csr(jm)
    tflat, toff = tra.second_order_csr(tm)
    np.testing.assert_array_equal(tflat, jflat)
    np.testing.assert_array_equal(toff, joff)
    assert tflat.dtype == jflat.dtype and toff.dtype == joff.dtype
    jn = jra.second_order_neighbors(jm)
    tn = tra.second_order_neighbors(tm)
    assert all(np.array_equal(a, b) for a, b in zip(tn, jn))


def test_untainted_greedy_equals_jax_for_one_seed(codes):
    jm, tm = codes["alist"]
    want = jra.select_punctured_bits_untainted(np.random.default_rng(5), jm)
    got = tra.select_punctured_bits_untainted(np.random.default_rng(5), tm)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    flat, offsets = tra.second_order_csr(tm)
    np.testing.assert_array_equal(
        tra._untainted_greedy_py(flat, offsets, 12345),
        jra._untainted_greedy_py(flat, offsets, 12345))


def test_committed_untp_reads_as_jax(codes):
    jm, tm = codes["qc"]
    jrng, trng = np.random.default_rng(8), np.random.default_rng(8)
    want = jra.get_punctured_bits_untainted(QC_1K, jrng, jm)
    got = tra.get_punctured_bits_untainted(QC_1K, trng, tm)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    # A read cache consumes nothing from the generator.
    assert trng.integers(0, 1 << 62) == np.random.default_rng(8).integers(
        0, 1 << 62)


def test_missing_untp_is_written_as_jax_writes_it(tmp_path, caplog):
    paths = []
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        paths.append(tmp_path / side / ALIST_1K.name)
        shutil.copy(ALIST_1K, paths[-1])
    jm = jread_matrix(paths[0], JFormat.ALIST)
    tm = tread_matrix(paths[1], TFormat.ALIST)
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    want = jra.get_punctured_bits_untainted(paths[0], jrng, jm)
    with caplog.at_level("WARNING"):
        got = tra.get_punctured_bits_untainted(paths[1], trng, tm)
    assert "will be automatically created" in caplog.text
    np.testing.assert_array_equal(got, want)
    jfile, tfile = (p.with_suffix(".untp") for p in paths)
    assert tfile.read_bytes() == jfile.read_bytes()
    assert trng.integers(0, 1 << 62) == jrng.integers(0, 1 << 62)
    # Now cached: read back without touching the generator.
    again = tra.get_punctured_bits_untainted(paths[1], trng, tm)
    np.testing.assert_array_equal(again, got)


def test_out_of_range_untp_raises(tmp_path):
    path = tmp_path / ALIST_1K.name
    shutil.copy(ALIST_1K, path)
    path.with_suffix(".untp").write_text("3 1024 ")
    tm = tread_matrix(path, TFormat.ALIST)
    with pytest.raises(ValueError, match="out of range"):
        tra.get_punctured_bits_untainted(path, np.random.default_rng(0), tm)


CONFIGS = {
    "example_rate_adapt": ("matrices_alist", [
        "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx",
        "(N=1024,M=256,R=0.75,CW=4,SEED=63).mtrx"]),
    "campaign_fec_measurement": ("matrices_qc", [
        "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx",
        "(N=1024,M=640,R=0.38,CW=4,Z=128,SEED=31).mtrx"]),
    "campaign_adaptive_aomsa": ("matrices_qc", [
        "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx",
        "(N=1024,M=512,R=0.50,CW=3,Z=128,SEED=12).mtrx"]),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("untainted", [True, False])
def test_prepare_sim_inputs_equals_jax(name, untainted, tmp_path):
    """The configs over their 1k matrices (the N=10240 and N=102400 ones
    only scale the host loops up): same combinations in the same order, and
    with random puncturing the same draws from the shared generator."""
    subdir, names = CONFIGS[name]
    cfg = json.loads((REPO / "configs" / f"{name}.json").read_text())
    cfg["code_rate_adaptation_parameters"]["enable_untainted_puncturing"] = \
        untainted
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jcfg, tcfg = jparse(path), tparse(path)
    matrices = [MATRICES / subdir / n for n in names]
    want = jsim.prepare_sim_inputs(matrices, jcfg)
    got = tsim.prepare_sim_inputs(matrices, tcfg)
    assert len(got) == len(want)
    total = 0
    for g, w in zip(got, want):
        assert g.matrix_path == w.matrix_path
        assert len(g.combinations) == len(w.combinations)
        for gc, wc in zip(g.combinations, w.combinations):
            assert gc.config_qber == wc.config_qber
            assert dataclasses.asdict(gc.scaling_factors) == \
                dataclasses.asdict(wc.scaling_factors)
            assert_params_equal(gc.matrix_params, wc.matrix_params)
        total += len(g.combinations)
    assert total > 0


# scripts/make_assets.py seeds each matrix's untainted cache with
# default_rng(base + the SEED of its file name): 1000 for QC codes, 2000 for
# alist, 3000 and 4000 for formats 1 and 2; 5001 and 5071 for the dense
# toys. The cache is written only where none exists, and seven committed
# caches hold another draw: the two 1k alist originals' caches predate the
# script's cache step, and the five Z=1024 N=102400 QC codes' caches do not
# regenerate from their seed with the JAX package's native greedy either.
ASSET_FORMATS = {"matrices_qc": TFormat.QC, "matrices_alist": TFormat.ALIST,
                 "matrices_1": TFormat.SPARSE_1, "matrices_2": TFormat.SPARSE_2,
                 "matrices_uncompressed": TFormat.UNCOMPRESSED}
SEED_BASE = {"matrices_qc": 1000, "matrices_alist": 2000, "matrices_1": 3000,
             "matrices_2": 4000}
ANOTHER_DRAW = {
    "matrices_alist/(N=1024,M=283,R=0.72,CW=4,SEED=6).mtrx",
    "matrices_alist/(N=1024,M=512,R=0.50,CW=3,SEED=5).mtrx",
    *(f"matrices_qc/(N=102400,{rest},Z=1024,SEED={seed}).mtrx"
      for rest, seed in (("M=65536,R=0.36,CW=4", 51), ("M=51200,R=0.50,CW=4", 52),
                         ("M=30720,R=0.70,CW=4", 53), ("M=15360,R=0.85,CW=4", 54),
                         ("M=8192,R=0.92,CW=4", 55))),
}
ASSETS = sorted(str(p.relative_to(MATRICES))
                for p in MATRICES.glob("*/*.mtrx"))


def _make_assets_seed(rel):
    folder, name = rel.split("/")
    if folder == "matrices_uncompressed":
        return 5071 if "SEED=71" in name else 5001
    return SEED_BASE[folder] + int(name.split("SEED=")[1].split(")")[0])


def _asset(rel):
    path = MATRICES / rel
    return path, tread_matrix(path, ASSET_FORMATS[rel.split("/")[0]])


@functools.lru_cache(maxsize=None)
def _port_draw(rel):
    """The port's untainted greedy on an asset from make_assets' seed."""
    _, matrix = _asset(rel)
    return tra.select_punctured_bits_untainted(
        np.random.default_rng(_make_assets_seed(rel)), matrix)


def test_every_committed_matrix_has_a_cache():
    assert len(ASSETS) == 40 and ANOTHER_DRAW <= set(ASSETS)
    assert all((MATRICES / rel).with_suffix(".untp").exists() for rel in ASSETS)


@pytest.mark.parametrize("rel", [a for a in ASSETS if a not in ANOTHER_DRAW])
def test_make_assets_untp_regenerates(rel):
    path, matrix = _asset(rel)
    got = tra.select_punctured_bits_untainted(
        np.random.default_rng(_make_assets_seed(rel)), matrix)
    text = " ".join(str(int(p)) for p in got) + " "
    assert text.encode() == path.with_suffix(".untp").read_bytes()


@pytest.mark.parametrize("rel", sorted(ANOTHER_DRAW))
def test_untp_of_another_draw_is_a_maximal_untainted_set(rel):
    path, matrix = _asset(rel)
    cached = np.array(path.with_suffix(".untp").read_text().split(), np.int64)
    flat, offsets = tra.second_order_csr(matrix)
    chosen = np.zeros(matrix.num_bit_nodes, bool)
    chosen[cached] = True
    covered = chosen.copy()
    for v in cached:
        row = flat[offsets[v]:offsets[v + 1]]
        assert not chosen[row].any(), f"bits {v} and a neighbour both chosen"
        covered[row] = True
    assert covered.all()
    assert not np.array_equal(_port_draw(rel), cached)


@pytest.mark.parametrize("rel", sorted(ANOTHER_DRAW))
def test_untp_of_another_draw_is_not_the_jax_greedy_either(rel):
    # From make_assets' seed the JAX package's greedy gives the port's
    # positions, and not the committed cache: the cache holds another draw.
    path = MATRICES / rel
    fmt = ASSET_FORMATS[rel.split("/")[0]]
    want = jra.select_punctured_bits_untainted(
        np.random.default_rng(_make_assets_seed(rel)),
        jread_matrix(path, JFormat(int(fmt))))
    np.testing.assert_array_equal(_port_draw(rel), want)
    cached = np.array(path.with_suffix(".untp").read_text().split(), np.int64)
    assert not np.array_equal(want, cached)
