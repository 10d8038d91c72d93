"""The port's Monte-Carlo sweep (qkd_ldpc_v_tpu_torch/simulation.py, cli.py)
against the JAX package's.

With a ``key_source`` that replays JAX's chunk streams (``trial_keys`` ->
``generate_keys`` -> ``jax.random.bits``), the port's ``run_combination``
on the CPU must equal JAX's ``run_combination`` field by field, and
``write_file`` must write the same bytes:
  * on a QC code, against JAX with ``use_pallas = true`` (the fused Pallas
    QC trial in interpret mode), in both schedules;
  * on a 1k alist code, the port's ``generic`` engine and its ``xla``
    engine in float32 and float64, each against JAX with ``use_pallas =
    false`` (its XLA decoder; JAX's own generic Pallas kernel is only
    statistically equal to it);
  * rate-adaptive runs (the key source also replays JAX's punctured draw):
    the ``qc`` engine against JAX's interpret-mode frame kernel in both
    schedules; the 1k alist code through ``generic`` and ``xla`` (float32
    and float64) against JAX's XLA decoder, AOMSA with privacy maintenance
    on; runs pinned to ``qc_stream`` and to ``stream``.
The engine cascade names the JAX package's engine on every committed
asset. The CLI runs end to end with ``--device cpu`` on QC and alist
workspaces, and on CPU-sized variants of the three rate-adaptive configs.
"""

import dataclasses
import json
import logging
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, MatrixFormat, RQBERRange
from qkd_ldpc_v_tpu.config import parse_config_data as jparse_config
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc, write_qc_matrix
from qkd_ldpc_v_tpu.ops import channel as jch
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
from qkd_ldpc_v_tpu.rate_adapt import get_punctured_bits_untainted as juntp
from qkd_ldpc_v_tpu_torch import cli as tcli
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix
from qkd_ldpc_v_tpu_torch import rate_adapt as tra
from qkd_ldpc_v_tpu_torch.ops import fused_generic, fused_qc, generic_stream, qc_stream
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
QBER = 0.075  # 76 errors in 1024 bits: some frames fail within the cap
ALIST_DIR = REPO / "sparse_matrices" / "matrices_alist"
ALIST_1K = ALIST_DIR / "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx"
ALIST_QBER = 0.05  # 51 errors: about half the frames fail within the cap


def _jax_cfg(schedule, **kw):
    base = dict(
        trials_number=24,
        simulation_seed=5,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=30,
        matrix_format=MatrixFormat.QC,
        r_qber_ranges=(RQBERRange(0.99, QBER, QBER, 0.01),),
        batch_size=16,  # two chunks, the second one short
        use_pallas=True,
        schedule=schedule,
    )
    base.update(kw)
    return Config(**base)


def _jax_key_source(seed):
    """JAX's chunk streams: Alice's keys (``ka``), the error-position bits
    (``ke``) and, in rate-adaptive runs, Alice's punctured draw
    (``kpa, _ = split(kp)``)."""
    def source(sim_number, chunk_index, batch, n, punctured=False):
        ka, ke, kp = jch.trial_keys(seed, sim_number, chunk_index)
        alice = np.asarray(jch.generate_keys(ka, batch, n))
        bits = np.asarray(jax.random.bits(ke, (batch, n), jnp.uint32))
        if not punctured:
            return alice, bits.astype(np.int64)
        kpa, _ = jax.random.split(kp)
        punct = np.asarray(jax.random.bernoulli(kpa, 0.5, (batch, n)))
        return alice, bits.astype(np.int64), punct.astype(np.int8)
    return source


@pytest.fixture(scope="module")
def matrices():
    jqc = generate_qc_ldpc(8, 4, 128, 3, seed=5)
    return jqc.to_hmatrix(), qc_from_arrays(jqc.shifts, jqc.lifting).to_hmatrix()


def _asdict(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_run_combination_matches_jax(matrices, schedule, tmp_path):
    jm, tm = matrices
    jcfg = _jax_cfg(schedule)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jcomb = jsim.SimCombination(QBER, JParams(), jsim.ScalingFactors(0.8))
    tcomb = tsim.SimCombination(QBER, TParams(), tsim.ScalingFactors(0.8))
    assert jsim.pallas_engine(jm, jcfg) == "qc"
    want = jsim.run_combination(jm, jcomb, jcfg, sim_number=1)
    fused_qc.reset_counts()
    got = tsim.run_combination(tm, tcomb, tcfg, 1, "cpu",
                               key_source=_jax_key_source(jcfg.simulation_seed))
    assert fused_qc.counts() == (0, 0)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0
    assert _asdict(got) == _asdict(want)

    jpath = jsim.write_file([want], jcfg, "00h-00m-01s", tmp_path / "jax")
    tpath = tsim.write_file([got], tcfg, "00h-00m-01s", tmp_path / "torch")
    assert tpath.name == jpath.name
    assert tpath.read_bytes() == jpath.read_bytes()


def test_write_file_matches_jax_with_throughput(tmp_path):
    """Same statistics -> same bytes, throughput columns and RTT included."""
    jcfg = _jax_cfg("layered", enable_throughput_measurement=True,
                    consider_rtt=True, rtt_ms=0.4,
                    decoding_algorithm=DecodingAlgorithm.AOMSA)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    fields = dict(sim_number=3, matrix_filename="m.mtrx", num_bit_nodes=1024,
                  num_check_nodes=512, config_qber=0.03, accurate_qber=0.0293,
                  iter_success_mean=7.25, iter_success_std=1.5,
                  iter_success_min=3, iter_success_max=17,
                  ratio_trials_success_decoding=0.75,
                  ratio_trials_success_ldpc=0.625, throughput_mean=123456,
                  throughput_std=789, throughput_min=100000,
                  throughput_max=150000)
    jr = jsim.SimResult(**fields, scaling_factors=jsim.ScalingFactors(0.3, 0.6))
    tr = tsim.SimResult(**fields, scaling_factors=tsim.ScalingFactors(0.3, 0.6))
    jpath = jsim.write_file([jr, jr], jcfg, "00h-01m-02s", tmp_path / "j")
    tpath = tsim.write_file([tr, tr], tcfg, "00h-01m-02s", tmp_path / "t")
    assert tpath.name == jpath.name
    assert tpath.read_bytes() == jpath.read_bytes()
    note = ".THROUGHPUT_NOTE.txt"
    assert (tpath.with_suffix(note).read_bytes()
            == jpath.with_suffix(note).read_bytes())


def _stream_sized_code():
    """N=22000 random regular code, column weight 3, row weight 6: 66000
    edges, beyond the generic engine's gate and inside the JAX package's
    stream gate; it decodes every frame at QBER 0.075 within 30
    iterations."""
    return generate_regular_ldpc(num_bits=22000, num_checks=11000,
                                 column_weight=3, seed=5)


@pytest.mark.parametrize("change,match", [
    (dict(enable_code_rate_adaptation=True), "rate adaptation"),
    (dict(decoding_algorithm=DecodingAlgorithm.SPA), "SPA"),
    ("stream-sized", "stream engine"),
    (dict(trace_decoding_alg=True), "traced"),
])
def test_unported_engines_raise(matrices, change, match, tmp_path, capsys):
    """What was not ported raised, naming its ROADMAP item. The four cases
    raised until their slice came and now run: the stream-sized case
    through the ``stream`` engine (8 frames of the N=22000 code on the
    CPU), rate adaptation through the ``qc`` engine's frame trial (a real
    adaptation point of the 1k QC code), SPA through the ``qc`` engine, held
    to JAX's run (its fused Pallas trial in interpret mode, on JAX's keys):
    every field of the result equal, the success ratios and the iteration
    statistics included, and the same CSV name and columns; and a traced
    run, which prints its iterations and equals the untraced float64 run
    in every field."""
    jm, tm = matrices
    comb = tsim.SimCombination(QBER, TParams(), tsim.ScalingFactors(0.8))
    if match == "SPA":
        jcfg = _jax_cfg("flooding", **change)
        tcfg = config_from_dict(dataclasses.asdict(jcfg))
        assert tsim.select_engine(tm, tcfg) == jsim.pallas_engine(jm, jcfg) == "qc"
        want = jsim.run_combination(
            jm, jsim.SimCombination(QBER, JParams(), jsim.ScalingFactors(0.8)),
            jcfg, sim_number=1)
        fused_qc.reset_counts()
        got = tsim.run_combination(
            tm, comb, tcfg, 1, "cpu",
            key_source=_jax_key_source(jcfg.simulation_seed))
        assert fused_qc.counts() == (0, 0)
        assert fused_qc.COUNTS.plain("trial") > 0
        assert 0.0 < got.ratio_trials_success_ldpc
        assert _asdict(got) == _asdict(want)
        jpath = jsim.write_file([want], jcfg, "00h-00m-01s", tmp_path / "jax")
        tpath = tsim.write_file([got], tcfg, "00h-00m-01s", tmp_path / "torch")
        assert tpath.name == jpath.name
        assert (tpath.read_text().splitlines()[0]
                == jpath.read_text().splitlines()[0])
        return
    if match == "rate adaptation":
        tcfg = config_from_dict(dataclasses.asdict(_jax_cfg("flooding", **change)))
        params = tra.adapt_code_rate(np.random.default_rng(3), tm, RA_QBER,
                                     0.1, 1.3)
        tra.finalize_bits_to_remove(tm, params, False)
        comb = tsim.SimCombination(RA_QBER, params, tsim.ScalingFactors(0.8))
        assert tsim.select_engine(tm, tcfg) == "qc"
        fused_qc.reset_counts()
        got = tsim.run_combination(tm, comb, tcfg, 0, "cpu")
        assert fused_qc.counts() == (0, 0)
        assert 0.0 < got.ratio_trials_success_decoding <= 1.0
        assert got.adapted_code_rate == params.adapted_code_rate
        return
    if change == "stream-sized":
        tcfg = config_from_dict(dataclasses.asdict(
            _jax_cfg("flooding", trials_number=8, batch_size=8)))
        code = _stream_sized_code()
        assert tsim.select_engine(code, tcfg) == match.split()[0]
        generic_stream.reset_counts()
        got = tsim.run_combination(code, comb, tcfg, 0, "cpu")
        assert generic_stream.counts() == (0, 0, 0, 0)
        assert 0.0 < got.ratio_trials_success_decoding <= 1.0
        return
    assert match == "traced"
    tcfg = config_from_dict(dataclasses.asdict(_jax_cfg(
        "flooding", trials_number=4, batch_size=4, dtype="float64", **change)))
    traced = tsim.run_combination(tm, comb, tcfg, 0, "cpu")
    assert "--- iteration 1 ---" in capsys.readouterr().out
    untraced = tsim.run_combination(
        tm, comb, dataclasses.replace(tcfg, trace_decoding_alg=False), 0, "cpu")
    assert _asdict(traced) == _asdict(untraced)


# ---------------------------------------------------------------------------
# Rate-adaptive runs against the JAX package
# ---------------------------------------------------------------------------

RA_QBER = 0.08  # the 1k QC code (R = 0.5) adapted to about 0.48


def _adapted(jm, tm, qber, delta, efficiency, privacy, scaling,
             untainted=False):
    """One adaptation point as a (JAX, port) pair of combinations, each
    package computing its own parameters from the same generator seed."""
    from qkd_ldpc_v_tpu import rate_adapt as jra

    jp = jra.adapt_code_rate(np.random.default_rng(3), jm, qber, delta,
                             efficiency, use_untainted=untainted)
    tp = tra.adapt_code_rate(np.random.default_rng(3), tm, qber, delta,
                             efficiency, use_untainted=untainted)
    assert not jp.is_empty
    jra.finalize_bits_to_remove(jm, jp, privacy)
    tra.finalize_bits_to_remove(tm, tp, privacy)
    np.testing.assert_array_equal(tp.bits_to_remove, jp.bits_to_remove)
    return (jsim.SimCombination(qber, jp, jsim.ScalingFactors(*scaling)),
            tsim.SimCombination(qber, tp, tsim.ScalingFactors(*scaling)))


def _ra_run_both(jm, tm, jcfg, tcfg, combs, tmp_path, monkeypatch):
    """(JAX SimResult, port SimResult) of one rate-adaptive combination with
    JAX's keys, the output key lengths both passed to the statistics, and
    the CSVs' equality."""
    lengths = {}
    for name, mod in (("jax", jsim), ("torch", tsim)):
        orig = mod.process_trials_results

        def spy(*args, _orig=orig, _name=name):
            lengths[_name] = args[5]
            return _orig(*args)

        monkeypatch.setattr(mod, "process_trials_results", spy)
    want = jsim.run_combination(jm, combs[0], jcfg, sim_number=1)
    got = tsim.run_combination(tm, combs[1], tcfg, 1, "cpu",
                               key_source=_jax_key_source(jcfg.simulation_seed))
    assert lengths["torch"] == lengths["jax"] == \
        tm.num_bit_nodes - len(combs[1].matrix_params.bits_to_remove)
    assert _asdict(got) == _asdict(want)
    jpath = jsim.write_file([want], jcfg, "00h-00m-01s", tmp_path / "jax")
    tpath = tsim.write_file([got], tcfg, "00h-00m-01s", tmp_path / "torch")
    assert tpath.name == jpath.name
    assert tpath.read_bytes() == jpath.read_bytes()
    assert ";FER;DELTA;EFFICIENCY;PUNCT_FRACTION;SHORT_FRACTION;R_ADAPTED;" \
        in tpath.read_text().splitlines()[0]
    return want, got


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_rate_adaptive_qc_matches_jax_frame_kernel(matrices, schedule,
                                                   tmp_path, monkeypatch):
    jm, tm = matrices
    jcfg = _jax_cfg(schedule, enable_code_rate_adaptation=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert jsim.pallas_engine(jm, jcfg) == tsim.select_engine(tm, tcfg) == "qc"
    combs = _adapted(jm, tm, RA_QBER, 0.1, 1.3, False, (0.8,))
    fused_qc.reset_counts()
    _, got = _ra_run_both(jm, tm, jcfg, tcfg, combs, tmp_path, monkeypatch)
    assert fused_qc.counts() == (0, 0)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0


RA_ALIST_QBER = 0.05  # the 1k alist code (R = 0.62) adapted to 0.60


@pytest.mark.parametrize("engine,dtype,alg,privacy", [
    ("generic", "float32", DecodingAlgorithm.NMSA, False),
    ("xla", "float32", DecodingAlgorithm.NMSA, False),
    ("xla", "float64", DecodingAlgorithm.NMSA, False),
    ("generic", "float32", DecodingAlgorithm.AOMSA, True),
])
def test_rate_adaptive_alist_matches_jax_xla(alist_1k, engine, dtype, alg,
                                             privacy, tmp_path, monkeypatch):
    """Untainted puncturing from the committed ``.untp`` cache; privacy
    maintenance shortens the output key by its own selection."""
    jm, tm = alist_1k
    jm.punctured_bits_untainted = juntp(ALIST_1K, np.random.default_rng(0), jm)
    tm.punctured_bits_untainted = tra.get_punctured_bits_untainted(
        ALIST_1K, np.random.default_rng(0), tm)
    kw = dict(dtype=dtype, decoding_algorithm=alg,
              enable_code_rate_adaptation=True,
              enable_untainted_puncturing=True,
              enable_privacy_maintenance=privacy)
    jcfg = _alist_cfg(**kw)
    tcfg = config_from_dict(dataclasses.asdict(
        _alist_cfg(use_pallas=engine == "generic", **kw)))
    assert tsim.select_engine(tm, tcfg) == engine
    assert jsim.pallas_engine(jm, jcfg) == "xla"
    scaling = (0.8,) if alg == DecodingAlgorithm.NMSA else (0.3, 0.6)
    combs = _adapted(jm, tm, RA_ALIST_QBER, 0.1, 1.4, privacy, scaling,
                     untainted=True)
    fused_generic.reset_counts()
    _, got = _ra_run_both(jm, tm, jcfg, tcfg, combs, tmp_path, monkeypatch)
    assert fused_generic.counts() == (0, 0)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0


def test_rate_adaptive_pinned_qc_stream_matches_jax(matrices, tmp_path,
                                                    monkeypatch):
    """``force_engine = qc_stream``: the streamed QC kernel's decode tail
    (Alice's syndrome in torch, its decode mode, the key compare) equals
    JAX's forced streamed run (its library decoder in interpret mode)."""
    jm, tm = matrices
    jcfg = _jax_cfg("layered", enable_code_rate_adaptation=True,
                    force_engine="qc_stream")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert jsim.pallas_engine(jm, jcfg) == tsim.select_engine(tm, tcfg) \
        == "qc_stream"
    combs = _adapted(jm, tm, RA_QBER, 0.1, 1.3, False, (0.8,))
    qc_stream.reset_counts()
    fused_qc.reset_counts()
    _, got = _ra_run_both(jm, tm, jcfg, tcfg, combs, tmp_path, monkeypatch)
    assert qc_stream.counts() == (0, 0) and fused_qc.counts() == (0, 0)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0


def test_rate_adaptive_pinned_stream_matches_jax_xla(tmp_path, monkeypatch):
    """``force_engine = stream`` on the 10k alist code: the streamed generic
    kernel's decode tail equals JAX's XLA decoder run (its own streamed
    kernel rounds messages to bf16 in flight)."""
    path = ALIST_DIR / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"
    jm = jread_matrix(path, MatrixFormat.ALIST)
    tm = tread_matrix(path, TFormat.ALIST)
    kw = dict(enable_code_rate_adaptation=True, trials_number=12,
              batch_size=8, decoding_alg_max_iterations=20)
    jcfg = _alist_cfg(**kw)
    tcfg = config_from_dict(dataclasses.asdict(
        _alist_cfg(use_pallas=True, force_engine="stream", **kw)))
    assert tsim.select_engine(tm, tcfg) == "stream"
    combs = _adapted(jm, tm, 0.03, 0.1, 1.5, False, (0.8,))
    generic_stream.reset_counts()
    _, got = _ra_run_both(jm, tm, jcfg, tcfg, combs, tmp_path, monkeypatch)
    assert generic_stream.counts() == (0, 0, 0, 0)
    assert got.ratio_trials_success_decoding > 0.0


def _alist_cfg(**kw):
    base = dict(
        trials_number=24,
        simulation_seed=5,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=30,
        matrix_format=MatrixFormat.ALIST,
        r_qber_ranges=(RQBERRange(0.99, ALIST_QBER, ALIST_QBER, 0.01),),
        batch_size=16,  # two chunks, the second one short
        use_pallas=False,
    )
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def alist_1k():
    return (jread_matrix(ALIST_1K, MatrixFormat.ALIST),
            tread_matrix(ALIST_1K, TFormat.ALIST))


@pytest.mark.parametrize("engine,dtype,alg", [
    ("generic", "float32", DecodingAlgorithm.NMSA),
    ("xla", "float32", DecodingAlgorithm.NMSA),
    ("xla", "float64", DecodingAlgorithm.NMSA),
    ("xla", "float64", DecodingAlgorithm.SPA),
])
def test_generic_codes_match_jax_xla(alist_1k, engine, dtype, alg, tmp_path):
    jm, tm = alist_1k
    jcfg = _alist_cfg(dtype=dtype, decoding_algorithm=alg)
    tcfg = config_from_dict(dataclasses.asdict(
        _alist_cfg(dtype=dtype, decoding_algorithm=alg,
                   use_pallas=engine == "generic")))
    assert tsim.select_engine(tm, tcfg) == engine
    assert jsim.pallas_engine(jm, jcfg) == "xla"
    jcomb = jsim.SimCombination(ALIST_QBER, JParams(), jsim.ScalingFactors(0.8))
    tcomb = tsim.SimCombination(ALIST_QBER, TParams(), tsim.ScalingFactors(0.8))
    want = jsim.run_combination(jm, jcomb, jcfg, sim_number=2)
    fused_generic.reset_counts()
    got = tsim.run_combination(tm, tcomb, tcfg, 2, "cpu",
                               key_source=_jax_key_source(jcfg.simulation_seed))
    assert fused_generic.counts() == (0, 0)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0
    assert _asdict(got) == _asdict(want)
    jpath = jsim.write_file([want], jcfg, "00h-00m-01s", tmp_path / "jax")
    tpath = tsim.write_file([got], tcfg, "00h-00m-01s", tmp_path / "torch")
    assert tpath.name == jpath.name
    assert tpath.read_bytes() == jpath.read_bytes()


def test_layered_on_a_generic_code_warns_and_floods(alist_1k, caplog):
    _, tm = alist_1k
    comb = tsim.SimCombination(ALIST_QBER, TParams(), tsim.ScalingFactors(0.8))
    results = {}
    for schedule in ("flooding", "layered"):
        tcfg = config_from_dict(dataclasses.asdict(
            _alist_cfg(use_pallas=True, schedule=schedule, trials_number=8,
                       batch_size=8)))
        with caplog.at_level(logging.WARNING):
            results[schedule] = _asdict(tsim.run_combination(tm, comb, tcfg, 0,
                                                             "cpu"))
    assert results["layered"] == results["flooding"]
    assert "using the flooding schedule" in caplog.text
    forced = config_from_dict(dataclasses.asdict(
        _alist_cfg(use_pallas=True, force_engine="qc")))
    with pytest.raises(ValueError, match="force_engine"):
        tsim.select_engine(tm, forced)


def test_cascade_on_the_headline_codes():
    """qc on the headline QC code, generic on the 10k alist code, stream on
    the 100k alist code, which the sweep accepts (no decode at N=102400
    here)."""
    cfg = config_from_dict(dataclasses.asdict(_alist_cfg(use_pallas=True)))
    headline = tread_matrix(
        REPO / "sparse_matrices" / "matrices_qc"
        / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx", TFormat.QC)
    alist_10k = tread_matrix(ALIST_DIR / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx",
                             TFormat.ALIST)
    alist_100k = tread_matrix(
        ALIST_DIR / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx", TFormat.ALIST)
    assert [tsim.select_engine(m, cfg) for m in (headline, alist_10k, alist_100k)] \
        == ["qc", "generic", "stream"]
    assert tsim.select_engine(alist_100k, cfg) == "stream"


_ASSETS = sorted(
    (path, fmt)
    for fmt in (MatrixFormat.ALIST, MatrixFormat.SPARSE_1, MatrixFormat.SPARSE_2,
                MatrixFormat.UNCOMPRESSED, MatrixFormat.QC)
    for path in (REPO / "sparse_matrices" / fmt.directory_name).glob("*.mtrx")
)


@pytest.mark.parametrize("path,fmt", _ASSETS,
                         ids=[f"{f.name}-{p.stem}" for p, f in _ASSETS])
def test_engine_equals_jax_on_every_asset(path, fmt, monkeypatch):
    # JAX's generic gate compiles the TPU kernel's Clos regroup tables after
    # its tile check; they take seconds at N=10240 and do not bear on the
    # verdict.
    from qkd_ldpc_v_tpu.ops import pallas_generic

    monkeypatch.setattr(pallas_generic, "build_permute_plan", lambda g: None)
    jm = jread_matrix(path, fmt)
    tm = tread_matrix(path, TFormat(int(fmt)))
    jcfg = Config(use_pallas=True)
    assert tsim.select_engine(tm, config_from_dict(dataclasses.asdict(jcfg))) \
        == jsim.pallas_engine(jm, jcfg)


def test_cuda_request_without_gpu_raises(matrices):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would run")
    _, tm = matrices
    tcfg = config_from_dict(dataclasses.asdict(_jax_cfg("layered")))
    comb = tsim.SimCombination(QBER, TParams(), tsim.ScalingFactors(0.8))
    fused_qc.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_combination(tm, comb, tcfg, 0, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--configs", "nowhere"])
    assert fused_qc.counts() == (0, 0)


def _cli_config(**overrides):
    cfg = {
        "threads_number": 1,
        "trials_number": 12,
        "use_config_simulation_seed": True,
        "simulation_seed": 7,
        "enable_privacy_maintenance": False,
        "enable_throughput_measurement": True,
        "throughput_measurement_parameters": {"consider_RTT": True, "RTT": 0.4},
        "decoding_algorithm": 2,
        "min_sum_normalized_parameters": {
            "use_alpha_range": False,
            "code_rate_alpha_maps": [{"code_rate": 0.99, "alpha": 0.65}],
        },
        "decoding_algorithm_max_iterations": 30,
        "matrix_format": 4,
        "trace_qkd_ldpc": False,
        "trace_decoding_algorithm": False,
        "trace_decoding_algorithm_llr": False,
        "enable_decoding_algorithm_msg_llr_threshold": False,
        "code_rate_QBER_ranges": [
            {"code_rate": 0.99, "QBER": {"begin": 0.02, "end": 0.03, "step": 0.01}}
        ],
        "enable_code_rate_adaptation": False,
        "tpu": {"batch_size": 8, "use_pallas": True, "schedule": "layered"},
    }
    cfg.update(overrides)
    return cfg


@pytest.fixture
def workspace(tmp_path):
    configs = tmp_path / "configs"
    matrices = tmp_path / "sparse_matrices" / "matrices_qc"
    configs.mkdir(parents=True)
    matrices.mkdir(parents=True)
    (configs / "run.json").write_text(json.dumps(_cli_config()))
    write_qc_matrix(generate_qc_ldpc(8, 4, 128, 3, seed=5),
                    matrices / "(N=1024,M=512,Z=128).mtrx")
    return tmp_path


def test_cli_end_to_end_on_cpu(workspace, capsys):
    fused_qc.reset_counts()
    rc = tcli.main([
        "--configs", str(workspace / "configs"),
        "--matrices", str(workspace / "sparse_matrices"),
        "--results", str(workspace / "results"),
        "--device", "cpu", "--quiet",
    ])
    out = capsys.readouterr()
    assert rc == 0, out.err
    csvs = list((workspace / "results").glob("*.csv"))
    assert len(csvs) == 1
    lines = csvs[0].read_text().splitlines()
    assert len(lines) == 3  # header + 2 QBER points
    assert lines[0].startswith("#;MATRIX_FILENAME;TYPE;R;M;N;")
    assert "THROUGHPUT_MEAN" in lines[0] and lines[0].endswith(";ALPHA")
    assert lines[1].split(";")[1] == "(N=1024,M=512,Z=128).mtrx"
    assert "CONFIG #1 INFO" in out.out
    assert "successfully completed" in out.out
    assert fused_qc.counts() == (0, 0)


def test_cli_reports_unported_config(workspace, capsys):
    """A rate-adaptive config and a trace flag, which this test once
    expected to be reported as unported, now run: the first writes the
    adaptation columns, the second prints its iterations and writes its
    CSV."""
    def run():
        return tcli.main([
            "--configs", str(workspace / "configs"),
            "--matrices", str(workspace / "sparse_matrices"),
            "--results", str(workspace / "results"),
            "--device", "cpu", "--quiet",
        ])

    (workspace / "configs" / "run.json").write_text(
        json.dumps(_cli_config(enable_code_rate_adaptation=True,
                               code_rate_adaptation_parameters={
                                   "enable_untainted_puncturing": False,
                                   "use_adaptation_parameters_ranges": False,
                                   "code_rate_QBER_adaptation_parameters_maps": [
                                       {"code_rate": 0.5, "QBER": 0.08,
                                        "delta": 0.1, "efficiency": 1.3}],
                               })))
    assert run() == 0, capsys.readouterr().err
    lines = next((workspace / "results").glob("*.csv")).read_text().splitlines()
    assert len(lines) == 2
    assert ";FER;DELTA;EFFICIENCY;PUNCT_FRACTION;SHORT_FRACTION;R_ADAPTED;" \
        in lines[0]
    assert lines[1].split(";")[15:17] == ["0,100", "1,300"]
    (workspace / "configs" / "run.json").write_text(
        json.dumps(_cli_config(trace_decoding_algorithm=True)))
    assert run() == 0, capsys.readouterr().err
    assert "--- iteration 1 ---" in capsys.readouterr().out
    assert len(list((workspace / "results").glob("*.csv"))) == 2


def test_cli_help_config(capsys):
    assert tcli.main(["--help-config"]) == 0
    assert "tpu.use_pallas" in capsys.readouterr().out


@pytest.fixture
def alist_workspace(tmp_path):
    configs = tmp_path / "configs"
    matrices = tmp_path / "sparse_matrices" / "matrices_alist"
    configs.mkdir(parents=True)
    matrices.mkdir(parents=True)
    cfg = _cli_config(matrix_format=1, tpu={"batch_size": 8, "use_pallas": True})
    cfg["code_rate_QBER_ranges"] = [
        {"code_rate": 0.99, "QBER": {"begin": 0.04, "end": 0.05, "step": 0.01}}]
    (configs / "run.json").write_text(json.dumps(cfg))
    shutil.copy(ALIST_1K, matrices / ALIST_1K.name)
    return tmp_path


def test_cli_end_to_end_on_alist(alist_workspace, capsys):
    fused_generic.reset_counts()
    rc = tcli.main([
        "--configs", str(alist_workspace / "configs"),
        "--matrices", str(alist_workspace / "sparse_matrices"),
        "--results", str(alist_workspace / "results"),
        "--device", "cpu", "--quiet",
    ])
    out = capsys.readouterr()
    assert rc == 0, out.err
    csvs = list((alist_workspace / "results").glob("*.csv"))
    assert len(csvs) == 1
    lines = csvs[0].read_text().splitlines()
    assert len(lines) == 3  # header + 2 QBER points
    assert lines[1].split(";")[1:6] == [ALIST_1K.name, "regular", "0,625",
                                         "384", "1024"]
    assert "successfully completed" in out.out
    assert fused_generic.counts() == (0, 0)


RA_CONFIGS = {
    "example_rate_adapt": ("matrices_alist", "(N=1024,M=384,R=0.62,CW=3,SEED=62)"),
    "campaign_fec_measurement": ("matrices_qc",
                                 "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33)"),
    "campaign_adaptive_aomsa": ("matrices_qc",
                                "(N=1024,M=512,R=0.50,CW=3,Z=128,SEED=12)"),
}


@pytest.mark.parametrize("name", list(RA_CONFIGS))
def test_cli_runs_rate_adaptive_configs_on_cpu(name, tmp_path, capsys):
    """CPU-sized variants of the three rate-adaptive configs (16 trials in
    chunks of 8, over one committed 1k matrix and its ``.untp`` cache, cap
    30) run through the CLI with ``--device cpu``: one CSV row per
    combination JAX's sweep makes, with the adaptation columns."""
    subdir, stem = RA_CONFIGS[name]
    cfg = json.loads((REPO / "configs" / f"{name}.json").read_text())
    cfg.update(trials_number=16, decoding_algorithm_max_iterations=30)
    cfg.setdefault("tpu", {})["batch_size"] = 8
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "run.json").write_text(json.dumps(cfg))
    matrices = tmp_path / "sparse_matrices" / subdir
    matrices.mkdir(parents=True)
    for suffix in (".mtrx", ".untp"):
        shutil.copy(REPO / "sparse_matrices" / subdir / (stem + suffix),
                    matrices / (stem + suffix))
    rc = tcli.main(["--configs", str(tmp_path / "configs"), "--matrices",
                    str(tmp_path / "sparse_matrices"), "--results",
                    str(tmp_path / "results"), "--device", "cpu", "--quiet"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    want = jsim.prepare_sim_inputs(
        [matrices / (stem + ".mtrx")],
        jparse_config(tmp_path / "configs" / "run.json"))
    csv = next((tmp_path / "results").glob("*.csv"))
    lines = csv.read_text().splitlines()
    assert len(lines) - 1 == len(want[0].combinations) > 0
    assert "rate_adapt=ON[punct=untainted]" in csv.name
    assert ";R_ADAPTED;THROUGHPUT_MEAN;" in lines[0]
