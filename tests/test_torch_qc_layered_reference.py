"""The benchmark's plain QC reference (``benchmark/reference/qc.py`` and
``layered.py``) against the port on the CPU: the QC reader's expansion
against ``models/qc.py``, edge for edge; the layered min-sum reference
against the port's normal sweep path (``run_combination`` on the ``qc``
engine, whose CPU path is the fused QC kernel's plain mc version, and on
the N=102400 flagship, which the fused kernel does not hold, the streamed
QC kernel's) frame for frame; and the reference in bfloat16 against
float32, which the benchmark's control of the QC sweeps relies on."""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import compare, layered
from benchmark.reference.qc import block_row_bits, expand, read_qc
from qkd_ldpc_v_tpu_torch import engines
from qkd_ldpc_v_tpu_torch import simulation as sim
from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm, MatrixFormat
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
from qkd_ldpc_v_tpu_torch.models.qc import (QCMatrix, generate_qc_ldpc,
                                            read_qc_matrix, write_qc_matrix)
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import base_tables
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams

ROOT = Path(__file__).resolve().parents[1]
HEADLINE = (ROOT / "sparse_matrices" / "matrices_qc"
            / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
# The N=102400 flagship, which the fused QC kernel does not hold: the
# streamed QC kernel decodes it.
FLAGSHIP = (ROOT / "sparse_matrices" / "matrices_qc"
            / "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx")
SEED = 2**31 + 77

# (primary, secondary) of each min-sum algorithm.
FACTORS = {"NMSA": (0.7, 1.0), "OMSA": (0.3, 1.0), "ANMSA": (0.7, 0.9),
           "AOMSA": (0.5, 1.0)}
# Small seeded QC codes (mb, nb, Z, column weight, seed) and a QBER in
# their waterfall. Z is a multiple of 128, as the fused QC kernel asks.
SMALL = [((3, 12, 128, 3, 1), 0.03), ((4, 8, 128, 3, 2), 0.08),
         ((6, 20, 128, 4, 3), 0.036)]


def random_base(seed: int) -> QCMatrix:
    """A random base matrix: 2-6 rows, 6-16 columns, Z 8-64, holes at
    random (every row keeps a block)."""
    rng = np.random.default_rng(seed)
    mb, nb = int(rng.integers(2, 7)), int(rng.integers(6, 17))
    z = int(rng.integers(8, 65))
    shifts = rng.integers(0, z, size=(mb, nb))
    shifts[rng.random((mb, nb)) < 0.4] = -1
    shifts[np.arange(mb), rng.integers(0, nb, size=mb)] = rng.integers(0, z, size=mb)
    return QCMatrix(shifts=shifts, lifting=z)


@pytest.mark.parametrize("source", ["headline", 0, 1, 2, 3])
def test_the_expansion_is_the_ports_matrix(source, tmp_path):
    if source == "headline":
        path = HEADLINE
    else:
        path = tmp_path / "random.mtrx"
        write_qc_matrix(random_base(source), path)
    qc = read_qc(path)
    port = read_qc_matrix(path)
    assert np.array_equal(qc.shifts, port.shifts) and qc.z == port.lifting
    code, h = expand(qc), port.to_hmatrix()
    assert (code.n, code.m) == (h.num_bit_nodes, h.num_check_nodes)
    assert len(code.rows) == len(h.check_nodes)
    for mine, theirs in zip(code.rows, h.check_nodes):
        assert np.array_equal(mine, np.asarray(theirs))
    for mine, theirs in zip(code.cols, h.bit_nodes):
        assert np.array_equal(mine, np.asarray(theirs))
    # The block-row tables follow the port's storage order and convention:
    # check r*Z + z of block edge (r, c, s) holds bit c*Z + (z + s) mod Z.
    rows, _, _ = base_tables(port)
    z = np.arange(qc.z)
    for r, row in enumerate(rows):
        bits = block_row_bits(qc, r)
        assert bits.shape == (qc.z, len(row))
        for k, (_, c, s) in enumerate(row):
            assert np.array_equal(bits[:, k], c * qc.z + (z + s) % qc.z)
        # Each bit appears at most once in a block-row.
        assert len(np.unique(bits)) == bits.size


def port_outcome(matrix, algorithm, qber, trials, chunk, cap,
                 kernel="fused_qc"):
    """Every frame's (converged, keys, iterations) of one combination of
    the port's normal path, layered, on the CPU, and its statistics;
    ``kernel`` is the QC kernel the ``qc`` engine has to choose."""
    log = []

    def factory(m, cfg, batch):
        step = sim.ChunkStep(m, cfg, "cpu", batch)

        def call(args, chunk_index, take):
            out = step(args, chunk_index, take)
            log.append(tuple(np.asarray(x)[:take] for x in out))
            return out

        return call

    cfg = Config(trials_number=trials, simulation_seed=SEED,
                 decoding_algorithm=DecodingAlgorithm[algorithm],
                 decoding_alg_max_iterations=cap,
                 matrix_format=MatrixFormat.QC, batch_size=chunk,
                 dtype="float32", use_pallas=True, schedule="layered")
    assert sim.select_engine(matrix, cfg) == "qc"
    assert engines._schedule("qc", matrix, cfg) == (kernel, True)
    primary, secondary = FACTORS[algorithm]
    comb = sim.SimCombination(qber, HMatrixParams(),
                              sim.ScalingFactors(primary=primary,
                                                 secondary=secondary))
    result = sim.run_combination(matrix, comb, cfg, 3, "cpu",
                                 step_factory=factory)
    got = compare.Outcome(*(np.concatenate([x[i] for x in log])
                            for i in range(3)))
    return got, result


def reference_outcome(qc, algorithm, qber, trials, chunk, cap,
                      dtype=torch.float32):
    primary, secondary = FACTORS[algorithm]
    return layered.sweep_combination(
        layered.Layers(qc, "cpu"), SEED, 3, qber, trials, chunk, algorithm,
        primary, secondary, cap, dtype=dtype, block=16)


def assert_same(got, result, want):
    assert compare.mismatched(got, want) == 0
    stats = {"ratio_dec": result.ratio_trials_success_decoding,
             "ratio_ldpc": result.ratio_trials_success_ldpc,
             "iter_mean": result.iter_success_mean,
             "iter_std": result.iter_success_std,
             "iter_min": result.iter_success_min,
             "iter_max": result.iter_success_max}
    assert compare.stats_gap(stats, compare.statistics(want)) == 0.0


@pytest.mark.parametrize("algorithm", list(FACTORS))
@pytest.mark.parametrize("shape, qber", SMALL)
def test_the_layered_reference_is_the_ports_sweep_on_small_codes(
        algorithm, shape, qber, tmp_path):
    mb, nb, z, cw, seed = shape
    path = tmp_path / "small.mtrx"
    write_qc_matrix(generate_qc_ldpc(nb, mb, z, cw, seed=seed), path)
    matrix = read_matrix(path, MatrixFormat.QC)
    got, result = port_outcome(matrix, algorithm, qber, 40, 16, 30)
    want = reference_outcome(read_qc(path), algorithm, qber, 40, 16, 30)
    assert_same(got, result, want)
    if algorithm == "NMSA":
        # The waterfall: some frames converge and some do not.
        assert 0 < want.converged.sum() < len(want.converged)


@pytest.fixture(scope="module")
def headline():
    return read_matrix(HEADLINE, MatrixFormat.QC), read_qc(HEADLINE)


@pytest.mark.parametrize("algorithm", list(FACTORS))
def test_the_layered_reference_is_the_ports_sweep_on_the_headline_code(
        algorithm, headline):
    matrix, qc = headline
    got, result = port_outcome(matrix, algorithm, 0.035, 32, 16, 30)
    want = reference_outcome(qc, algorithm, 0.035, 32, 16, 30)
    assert_same(got, result, want)


def test_bfloat16_changes_the_headline_outcome(headline):
    _, qc = headline
    f32 = reference_outcome(qc, "NMSA", 0.035, 32, 16, 30)
    bf16 = reference_outcome(qc, "NMSA", 0.035, 32, 16, 30,
                             dtype=torch.bfloat16)
    assert compare.mismatched(bf16, f32) > 0


@pytest.fixture(scope="module")
def flagship():
    return read_matrix(FLAGSHIP, MatrixFormat.QC), read_qc(FLAGSHIP)


@pytest.mark.parametrize("algorithm", list(FACTORS))
def test_the_layered_reference_is_the_ports_sweep_on_the_flagship(
        algorithm, flagship):
    matrix, qc = flagship
    got, result = port_outcome(matrix, algorithm, 0.035, 16, 8, 30,
                               kernel="qc_stream")
    want = reference_outcome(qc, algorithm, 0.035, 16, 8, 30)
    assert_same(got, result, want)


def test_bfloat16_changes_the_flagship_outcome(flagship):
    _, qc = flagship
    f32 = reference_outcome(qc, "NMSA", 0.035, 16, 8, 30)
    bf16 = reference_outcome(qc, "NMSA", 0.035, 16, 8, 30,
                             dtype=torch.bfloat16)
    assert compare.mismatched(bf16, f32) > 0
