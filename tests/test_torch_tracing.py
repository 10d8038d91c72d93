"""The port's traced decode (qkd_ldpc_v_tpu_torch/oracle.py, tracing.py and
the traced path of simulation.py) against the JAX package's, the
counterpart of tests/test_tracing.py.

  * The oracle copy equals JAX's oracle: decisions, convergence, iterations
    and every field of every ``TraceIteration``, on the Johnson matrix and
    the conftest's medium code, all six algorithms, the clamp on and off.
  * ``traced_decode`` and ``traced_protocol_round`` print JAX's text
    character for character, under each trace flag.
  * A traced ``run_combination`` equals the untraced float64 (``xla``) run
    in every field, fixed rate and rate adaptive, and prints each trial.
  * Fed JAX's chunk keys, a traced run gives JAX's traced statistics and
    prints JAX's text.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu import oracle as joracle
from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu import tracing as jtracing
from qkd_ldpc_v_tpu.config import Config as JConfig
from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
from qkd_ldpc_v_tpu.config import RQBERRange as JRange
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc as jgenerate
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
from qkd_ldpc_v_tpu_torch import oracle as toracle
from qkd_ldpc_v_tpu_torch import rate_adapt as tra
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch import tracing as ttracing
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, hmatrix_from_rows
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams
from test_torch_simulation import _jax_key_source

torch.set_num_threads(2)

FACTORS = {0: (1.0, 1.0), 1: (1.0, 1.0), 2: (0.8, 1.0), 3: (0.3, 1.0),
           4: (0.88, 0.5), 5: (0.3, 0.6)}


def _port(jm):
    return hmatrix_from_rows(jm.check_nodes, jm.num_bit_nodes)


def _frame(matrix, qber, seed):
    """(alice, f64 LLRs, Alice's oracle syndrome) of one frame with exactly
    floor(N * qber) errors, from a numpy seed."""
    n = matrix.num_bit_nodes
    rng = np.random.default_rng(seed)
    alice = rng.integers(0, 2, n)
    bob = alice.copy()
    ne = max(1, int(n * qber))
    bob[rng.permutation(n)[:ne]] ^= 1
    log_p = np.log((1.0 - ne / n) / (ne / n))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float64)
    return alice, bob, llr, joracle.calculate_syndrome(matrix.check_nodes, alice)


def _jcfg(**kw):
    base = dict(trials_number=4, simulation_seed=11,
                decoding_algorithm=JAlg.SPA, decoding_alg_max_iterations=30,
                r_qber_ranges=(JRange(0.99, 0.03, 0.03, 0.01),))
    base.update(kw)
    return JConfig(**base)


def _tcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _assert_traces_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ == "TraceIteration"
        for f in dataclasses.fields(w):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if isinstance(wv, list):
                assert len(gv) == len(wv), f.name
                for a, b in zip(gv, wv):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b, err_msg=f.name)
            elif isinstance(wv, np.ndarray):
                assert gv.dtype == wv.dtype, f.name
                np.testing.assert_array_equal(gv, wv, err_msg=f.name)
            else:
                assert gv == wv and type(gv) is type(wv), f.name


@pytest.mark.parametrize("use_thr", [False, True], ids=["no_clamp", "clamp"])
@pytest.mark.parametrize("alg", range(6))
@pytest.mark.parametrize("code", ["johnson", "medium"])
def test_oracle_copy_equals_jax(johnson_matrix, medium_matrix, code, alg,
                                use_thr):
    jm = johnson_matrix if code == "johnson" else medium_matrix
    qber = 0.2 if code == "johnson" else 0.07
    alice, _, llr, syn = _frame(jm, qber, seed=alg)
    f1, f2 = FACTORS[alg]
    args = (alg, 30, f1, f2, 2.5 if use_thr else 0.0, use_thr)
    wtrace, gtrace = [], []
    want = joracle.decode_oracle(jm, llr, syn, *args, trace=wtrace)
    got = toracle.decode_oracle(_port(jm), llr, syn, *args, trace=gtrace)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    _assert_traces_equal(gtrace, wtrace)
    np.testing.assert_array_equal(
        toracle.calculate_syndrome(_port(jm).check_nodes, alice), syn)


TRACE_FLAGS = {
    "alg": dict(trace_decoding_alg=True),
    "llr": dict(trace_decoding_alg_llr=True),
    "alg_llr": dict(trace_decoding_alg=True, trace_decoding_alg_llr=True),
    "qkd": dict(trace_qkd_ldpc=True),
    "all": dict(trace_qkd_ldpc=True, trace_decoding_alg=True,
                trace_decoding_alg_llr=True),
}


@pytest.mark.parametrize("flags", list(TRACE_FLAGS))
@pytest.mark.parametrize("alg", [0, 2, 5])
def test_traced_decode_prints_jax_text(johnson_matrix, capsys, alg, flags):
    jcfg = _jcfg(decoding_algorithm=JAlg(alg), enable_msg_llr_threshold=True,
                 msg_llr_threshold=100.0, **TRACE_FLAGS[flags])
    _, _, llr, syn = _frame(johnson_matrix, 0.2, seed=3)
    f1, f2 = FACTORS[alg]
    want = jtracing.traced_decode(johnson_matrix, llr, syn, jcfg, f1, f2)
    want_out = capsys.readouterr().out
    got = ttracing.traced_decode(_port(johnson_matrix), llr, syn, _tcfg(jcfg),
                                 f1, f2)
    got_out = capsys.readouterr().out
    assert got_out == want_out
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    _assert_traces_equal(got[3], want[3])


@pytest.mark.parametrize("flags", list(TRACE_FLAGS))
@pytest.mark.parametrize("code", ["johnson", "medium"])
def test_traced_protocol_round_prints_jax_text(johnson_matrix, medium_matrix,
                                               capsys, code, flags):
    jm = johnson_matrix if code == "johnson" else medium_matrix
    qber = 1 / 6 if code == "johnson" else 0.07
    alice, bob, _, _ = _frame(jm, qber, seed=9)
    jcfg = _jcfg(decoding_algorithm=JAlg.NMSA, **TRACE_FLAGS[flags])
    want = jtracing.traced_protocol_round(jm, alice, bob, qber, jcfg, 0.8)
    want_out = capsys.readouterr().out
    got = ttracing.traced_protocol_round(_port(jm), alice, bob, qber,
                                         _tcfg(jcfg), 0.8)
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert "Keys matched" in got_out or flags not in ("qkd", "all")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _tparams(tm, qber, delta, efficiency, seed):
    params = tra.adapt_code_rate(np.random.default_rng(seed), tm, qber, delta,
                                 efficiency)
    assert not params.is_empty
    tra.finalize_bits_to_remove(tm, params, False)
    return params


@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
def test_traced_run_equals_untraced_f64(medium_matrix, capsys, rate_adaptive):
    """The traced (oracle) path and the untraced float64 path decode the
    same keys and frames, so every statistic agrees (the counterparts of
    test_traced_driver_matches_untraced_f64 and
    test_traced_rate_adapt_matches_device_f64)."""
    tm = _port(medium_matrix)
    qber = 0.075
    params = (_tparams(tm, qber, 0.1, 1.35, seed=2) if rate_adaptive
              else TParams())
    comb = tsim.SimCombination(qber, params, tsim.ScalingFactors(0.8))
    jcfg = _jcfg(trials_number=12, batch_size=8, dtype="float64",
                 decoding_algorithm=JAlg.NMSA,
                 enable_code_rate_adaptation=rate_adaptive,
                 r_qber_ranges=(JRange(0.99, qber, qber, 0.01),))
    traced_cfg = _tcfg(dataclasses.replace(jcfg, trace_qkd_ldpc=True))
    traced = tsim.run_combination(tm, comb, traced_cfg, 1, "cpu")
    out = capsys.readouterr().out
    assert out.count("Trial ") == 12
    untraced = tsim.run_combination(tm, comb, _tcfg(jcfg), 1, "cpu")
    assert tsim.select_engine(tm, _tcfg(jcfg)) == "xla"
    assert dataclasses.asdict(traced) == dataclasses.asdict(untraced)
    assert 0.0 < traced.ratio_trials_success_ldpc < 1.0


@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
def test_traced_run_on_jax_keys_equals_jax(capsys, rate_adaptive):
    """Fed JAX's chunk keys (and, rate adaptive, its punctured draw), a
    traced run prints JAX's text and gives JAX's statistics."""
    from qkd_ldpc_v_tpu import rate_adapt as jra

    jm = jgenerate(256, 128, 3, seed=13)
    tm = _port(jm)
    qber = 0.08
    jparams, tparams = JParams(), TParams()
    if rate_adaptive:
        jparams = jra.adapt_code_rate(np.random.default_rng(2), jm, qber, 0.2, 1.3)
        jra.finalize_bits_to_remove(jm, jparams, False)
        tparams = _tparams(tm, qber, 0.2, 1.3, seed=2)
        np.testing.assert_array_equal(tparams.bits_to_remove,
                                      jparams.bits_to_remove)
    jcfg = _jcfg(trials_number=10, batch_size=4, simulation_seed=6,
                 decoding_algorithm=JAlg.SPA, decoding_alg_max_iterations=40,
                 enable_code_rate_adaptation=rate_adaptive,
                 r_qber_ranges=(JRange(0.99, qber, qber, 0.01),),
                 trace_qkd_ldpc=True, trace_decoding_alg_llr=True)
    want = jsim.run_combination(
        jm, jsim.SimCombination(qber, jparams, jsim.ScalingFactors()), jcfg,
        sim_number=2)
    want_out = capsys.readouterr().out
    got = tsim.run_combination(
        tm, tsim.SimCombination(qber, tparams, tsim.ScalingFactors()),
        _tcfg(jcfg), 2, "cpu",
        key_source=_jax_key_source(jcfg.simulation_seed))
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert got_out.count("Trial ") == 10
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0
