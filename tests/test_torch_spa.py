"""The SPA pair (SPA and SPA-lin-approx) in the port, against the JAX
package and against itself.

  * The plain QC decoder (``ops/qc_decoder.py::decode_flooding``) against
    JAX's fused QC and streamed QC Pallas kernels in interpret mode and
    against JAX's XLA decoders (the QC roll decoder and the generic
    decoder), at PARITY.md level 2: decisions and ``syndromes_match``
    equal on every frame, the forced and the failing frames included, and
    iterations within one. XLA's float32 tanh is its own approximation and
    JAX's kernels take atanh through the log identity, so bit equality of
    the messages is not the contract here; on the card the port's kernels
    are held to these plain versions exactly (chip_smoke.py, phase 2g).
  * The plain QC decoder equals the plain generic decoder
    (``ops/decoders.py``) on a QC code exactly: both multiply the row
    product sequentially from the syndrome sign in slot order.
  * ``_prod_terms`` is that sequential product in float32 and float64 (the
    order of ``qkd_ldpc_v_tpu/oracle.py``).
  * The SPA-lin tables and the atanh guard at NaN, +-0, +-inf and every
    segment bound; ``ops/spa.py``'s CPU route.
  * Routing: ``select_engine`` names JAX's
    ``pallas_engine`` for SPA configs on every committed asset; the layered
    schedule floods with a warning in the sweep and raises ``ValueError``
    in the QC decoders; ``montecarlo_trial`` on an SPA config runs
    ``mc_channel`` and the plain trial on the CPU.

Small codes only.
"""

import dataclasses
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import Config
from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
from qkd_ldpc_v_tpu.config import MatrixFormat
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu.models.layout import compile_layout, layout_for
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc
from qkd_ldpc_v_tpu.ops import linapprox as jlin
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu.ops.decoders import get_decoder as jget_decoder
from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_decoder
from qkd_ldpc_v_tpu.ops.pallas_qc_stream import make_pallas_qc_stream_decoder
from qkd_ldpc_v_tpu.ops.qc_decoder import make_qc_decoder
from qkd_ldpc_v_tpu_torch import engines
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix
from qkd_ldpc_v_tpu_torch.models.layout import layout_for as tlayout_for
from qkd_ldpc_v_tpu_torch.ops import fused_qc, launch, spa
from qkd_ldpc_v_tpu_torch.ops.channel import chunk_seed, log_ratio, mc_channel
from qkd_ldpc_v_tpu_torch.ops.decoders import _prod_terms, get_decoder
from qkd_ldpc_v_tpu_torch.ops.linapprox import (
    _ATANH_BOUNDS,
    _TANH_BOUNDS,
    atanh_lin_approx,
    guard_atanh_ratio,
    tanh_lin_approx,
)
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import decode_flooding, decode_layered
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CAP = 30
ALGS = ("SPA", "SPA_APPROX")


@pytest.fixture(scope="module")
def codes():
    jqc = generate_qc_ldpc(base_bits=8, base_checks=4, lifting=128,
                           column_weight=3, seed=5)
    return jqc, qc_from_arrays(jqc.shifts, jqc.lifting)


@pytest.fixture(scope="module")
def channel(codes):
    """16 frames of the 1k QC code, half at QBER 0.04 and half at 0.085
    (where some frames fail within the cap); frame 0 carries a zero LLR
    (the 0/0 ratio) and frame 1 every LLR times eight (tanh(m/2) rounds to
    +-1, and the guard clamps)."""
    jqc, _ = codes
    rng = np.random.default_rng(21)
    n = jqc.num_bit_nodes
    alice = rng.integers(0, 2, (16, n)).astype(np.int8)
    p = np.repeat([0.04, 0.085], 8)[:, None]
    bob = alice ^ (rng.random((16, n)) < p).astype(np.int8)
    log_p = np.log((1 - p) / p).astype(np.float32)
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float32)
    llr[0, 0] = 0.0
    llr[1] *= 8.0
    syn = np.asarray(calculate_syndrome(layout_for(jqc.to_hmatrix()),
                                        jnp.asarray(alice)))
    return llr, syn


def _port(tqc, alg, llr, syn, use_thr, thr):
    r = decode_flooding(tqc, torch.tensor(llr), torch.tensor(syn), TAlg[alg],
                        CAP, use_thr, 1.0, 1.0, thr)
    return (r.decision.numpy(), r.syndromes_match.numpy(),
            r.iterations.numpy())


def _assert_parity_level_2(got, want):
    dec, conv, iters = got
    wdec, wconv, witers = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(conv, wconv)
    np.testing.assert_array_equal(dec, wdec)
    assert np.abs(iters.astype(np.int64) - witers.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("alg,use_thr,thr", [
    ("SPA", False, 0.0), ("SPA", True, 2.5), ("SPA_APPROX", False, 0.0),
    ("SPA_APPROX", True, 100.0)])
def test_plain_qc_spa_pair_holds_to_jax(codes, channel, alg, use_thr, thr):
    """JAX's fused QC and streamed QC kernels (interpret mode) and its XLA
    QC and generic decoders, at PARITY level 2 on every frame: frame 0's
    0/0 ratio and frame 1's clamped ratios reach the guard, and the frames
    that fail within the cap end on the same decisions, so a guard or a
    clamp at another program point shows."""
    jqc, tqc = codes
    llr, syn = channel
    got = _port(tqc, alg, llr, syn, use_thr, thr)
    assert 0 < got[1].sum() < 16 or thr == 2.5
    decoders = {
        "pallas_qc": make_pallas_qc_decoder(jqc, JAlg[alg], CAP, use_thr,
                                            batch_tile=8, interpret=True),
        "pallas_qc_stream": make_pallas_qc_stream_decoder(
            jqc, JAlg[alg], CAP, use_thr, batch_tile=8, interpret=True),
        "xla_qc": make_qc_decoder(jqc, JAlg[alg], CAP, use_thr),
        "xla_generic": jget_decoder(compile_layout(jqc.to_hmatrix()),
                                    JAlg[alg], CAP, use_thr,
                                    dtype=jnp.float32),
    }
    for name, dec in decoders.items():
        res = jax.device_get(dec(jnp.asarray(llr), jnp.asarray(syn), 1.0, 1.0,
                                 thr))
        try:
            _assert_parity_level_2(
                got, (res.decision, res.syndromes_match, res.iterations))
        except AssertionError as err:
            raise AssertionError(f"against {name}") from err


@pytest.mark.parametrize("thr", [None, 2.5, 100.0])
@pytest.mark.parametrize("alg", ALGS)
def test_plain_qc_equals_plain_generic_exactly(codes, channel, alg, thr):
    """Both plain versions multiply the row product sequentially from the
    syndrome sign in slot order and sum the totals llr-first, so on a QC
    code they agree bit for bit: decisions, convergence, iterations."""
    _, tqc = codes
    llr, syn = channel
    use_thr = thr is not None
    got = _port(tqc, alg, llr, syn, use_thr, thr or 0.0)
    dec = get_decoder(tlayout_for(tqc.to_hmatrix()), TAlg[alg], CAP, use_thr,
                      torch.float32)
    res = dec(torch.tensor(llr), torch.tensor(syn), 1.0, 1.0, thr or 0.0)
    np.testing.assert_array_equal(got[0], res.decision.numpy())
    np.testing.assert_array_equal(got[1], res.syndromes_match.numpy())
    np.testing.assert_array_equal(got[2], res.iterations.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prod_terms_is_sequential_from_the_syndrome_sign(dtype):
    """``_prod_terms`` multiplies in slot order from ``init``, as the oracle
    does (``row_prod *= t[k]``) and every kernel of both packages."""
    rng = np.random.default_rng(4)
    terms = np.tanh(rng.normal(0.0, 3.0, (64, 15, 32)) * 0.5)
    init = np.where(rng.random((64, 32)) < 0.5, -1.0, 1.0)
    nd = np.float32 if dtype == torch.float32 else np.float64
    want = init.astype(nd)
    for s in range(terms.shape[1]):
        want = want * terms[:, s, :].astype(nd)
    got = _prod_terms(torch.tensor(init, dtype=dtype),
                      torch.tensor(terms, dtype=dtype))
    np.testing.assert_array_equal(got.numpy(), want)


def _segments(bounds):
    """Every bound, the float32 values on either side of it, +-0, +-inf and
    NaN, with both signs."""
    pts = [0.0, np.inf, np.nan]
    for b in bounds:
        b32 = np.float32(b)
        pts += [b32, np.nextafter(b32, np.float32(0)),
                np.nextafter(b32, np.float32(np.inf))]
    pts = np.array(pts, dtype=np.float32)
    return np.concatenate([pts, -pts])


@pytest.mark.parametrize("which", ["tanh", "atanh"])
def test_lin_tables_at_nan_zero_and_segment_bounds(which):
    """The tables are first-true-wins ladders on |x| < bound; a NaN fails
    every bound (tanh_lin: 1, with the sign of x < 0 false; atanh_lin: the
    last segment, NaN); the sign is applied as x < 0 ? -r : r, so -0 takes
    the + branch. JAX's tables give the same values."""
    fn, jfn, bounds = {
        "tanh": (tanh_lin_approx, jlin.tanh_lin_approx, _TANH_BOUNDS),
        "atanh": (atanh_lin_approx, jlin.atanh_lin_approx, _ATANH_BOUNDS),
    }[which]
    x = _segments(bounds)
    got = fn(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(x))))
    nan = np.isnan(x)
    if which == "tanh":
        assert (got[nan] == 1.0).all()
        zero = got[x == 0]
        assert (zero == 0).all() and not np.signbit(zero).any()
        assert (got[np.isinf(x)] == np.sign(x[np.isinf(x)])).all()
        # At a bound the next segment applies.
        b = np.float32(_TANH_BOUNDS[0])
        assert fn(torch.tensor([b])).item() == np.float32(
            np.float32(0.6355) * b + np.float32(0.1444))
    else:
        assert np.isnan(got[nan]).all()
        assert (got[x == 0] == np.float32(-0.0323)).all()


def test_atanh_guard_and_the_spa_step_entry():
    """The guard turns NaN into 0 and clamps to the largest float32 below
    one; ``ops/spa.py`` takes the plain steps on the CPU (counted) and
    raises for a device without a kernel."""
    x = torch.tensor([np.nan, 1.0, -1.0, 2.0, -0.0, 0.5], dtype=torch.float32)
    limit = np.float32(1.0) - np.float32(2.0 ** -24)
    got = guard_atanh_ratio(x).numpy()
    np.testing.assert_array_equal(got, np.array(
        [0.0, limit, -limit, limit, -0.0, 0.5], dtype=np.float32))
    assert np.signbit(got[4])
    spa.COUNTS.reset()
    for step in spa.STEPS:
        y = spa.spa_step(x, step)
        torch.testing.assert_close(y, spa.plain_step(x, step), equal_nan=True,
                                   rtol=0, atol=0)
    assert spa.COUNTS.plain_calls[("cpu", "tanh")] == 1
    assert spa.COUNTS.launches == 0
    assert torch.isfinite(spa.spa_step(x, "atanh")).all()
    with pytest.raises(NotImplementedError, match="meta"):
        spa.spa_step(torch.empty(4, device="meta"), "tanh")
    with pytest.raises(ValueError, match="step"):
        spa.spa_step(x, "cosh")


def test_layered_spa_raises_in_the_decoders_and_floods_in_the_sweep(
        codes, caplog):
    """The QC decoders refuse the layered schedule with the SPA pair, as
    JAX's ``_build`` does; the sweep warns and floods, and its run equals
    the flooding run."""
    jqc, tqc = codes
    llr = torch.zeros((2, tqc.num_bit_nodes))
    syn = torch.zeros((2, tqc.num_check_nodes), dtype=torch.int8)
    for alg in ALGS:
        with pytest.raises(ValueError, match="layered"):
            decode_layered(tqc, llr, syn, TAlg[alg], CAP, False)
        with pytest.raises(ValueError, match="layered"):
            launch.kernel_flags(TAlg[alg], True)
    matrix = tqc.to_hmatrix()
    comb = tsim.SimCombination(0.06, TParams(), tsim.ScalingFactors(1.0))
    results = {}
    for schedule in ("layered", "flooding"):
        cfg = config_from_dict(dataclasses.asdict(Config(
            trials_number=16, batch_size=16, simulation_seed=3,
            decoding_algorithm=JAlg.SPA, decoding_alg_max_iterations=CAP,
            use_pallas=True, schedule=schedule)))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            results[schedule] = tsim.run_combination(matrix, comb, cfg, 0,
                                                     "cpu")
        warned = any("flooding" in r.getMessage() for r in caplog.records)
        assert warned == (schedule == "layered")
        assert engines._schedule("qc", matrix, cfg) == ("fused_qc", False)
    assert dataclasses.asdict(results["layered"]) == \
        dataclasses.asdict(results["flooding"])


def test_montecarlo_trial_of_an_spa_config_is_mc_channel_and_plain_trial(
        codes):
    """A fixed-rate SPA run on the ``qc`` engine draws its keys in the mc
    mode; on the CPU that is ``channel.mc_channel`` followed by the plain
    trial."""
    _, tqc = codes
    matrix = tqc.to_hmatrix()
    cfg = config_from_dict(dataclasses.asdict(Config(
        trials_number=16, batch_size=16, simulation_seed=3,
        decoding_algorithm=JAlg.SPA_APPROX, decoding_alg_max_iterations=CAP,
        use_pallas=True, schedule="layered")))
    mc = tsim.montecarlo_trial("qc", matrix, cfg)
    n = matrix.num_bit_nodes
    ne = int(n * 0.07)
    seed = chunk_seed(3, 0, 0)
    fused_qc.reset_counts()
    got = mc(seed, 5, 16, ne, log_ratio(ne / n), 1.0, 1.0, 0.0, device="cpu")
    assert fused_qc.COUNTS.plain("mc") == 1
    assert fused_qc.counts() == (0, 0) and fused_qc.COUNTS.mc_launches == 0
    alice, bob = mc_channel(seed, 5, 16, n, ne, "cpu")
    want = fused_qc.make_fused_qc_trial(tqc, TAlg.SPA_APPROX, CAP, False).plain(
        alice, bob, log_ratio(ne / n), 1.0, 1.0, 0.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(got[0].sum()) <= 16


_ASSETS = sorted(
    (path, fmt)
    for fmt in (MatrixFormat.ALIST, MatrixFormat.SPARSE_1, MatrixFormat.SPARSE_2,
                MatrixFormat.UNCOMPRESSED, MatrixFormat.QC)
    for path in (REPO / "sparse_matrices" / fmt.directory_name).glob("*.mtrx")
)


@pytest.mark.parametrize("path,fmt", _ASSETS,
                         ids=[f"{f.name}-{p.stem}" for p, f in _ASSETS])
def test_engine_for_spa_configs_equals_jax_on_every_asset(path, fmt,
                                                          monkeypatch):
    """SPA configs, layered asked for or not, reach the engine JAX's
    ``pallas_engine`` names, and ``select_engine`` does not refuse them."""
    from qkd_ldpc_v_tpu.ops import pallas_generic

    monkeypatch.setattr(pallas_generic, "build_permute_plan", lambda g: None)
    jm = jread_matrix(path, fmt)
    tm = tread_matrix(path, TFormat(int(fmt)))
    for alg in (JAlg.SPA, JAlg.SPA_APPROX):
        for schedule in ("flooding", "layered"):
            jcfg = Config(use_pallas=True, decoding_algorithm=alg,
                          schedule=schedule)
            tcfg = config_from_dict(dataclasses.asdict(jcfg))
            assert tsim.select_engine(tm, tcfg) == jsim.pallas_engine(jm, jcfg)
