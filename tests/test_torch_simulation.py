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
    statistically equal to it).
The engine cascade names the JAX package's engine on every committed
asset. The CLI runs end to end with ``--device cpu`` on QC and alist
workspaces.
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
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc, write_qc_matrix
from qkd_ldpc_v_tpu.ops import channel as jch
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
from qkd_ldpc_v_tpu_torch import cli as tcli
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix
from qkd_ldpc_v_tpu_torch.ops import fused_generic, fused_qc, generic_stream
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
    def source(sim_number, chunk_index, batch, n):
        ka, ke, _ = jch.trial_keys(seed, sim_number, chunk_index)
        alice = np.asarray(jch.generate_keys(ka, batch, n))
        bits = np.asarray(jax.random.bits(ke, (batch, n), jnp.uint32))
        return alice, bits.astype(np.int64)
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
def test_unported_engines_raise(matrices, change, match):
    """What is not ported raises; the stream-sized case, which raised until
    the streamed generic kernel came, now runs through the ``stream``
    engine (8 frames of the N=22000 code on the CPU)."""
    _, tm = matrices
    comb = tsim.SimCombination(QBER, TParams(), tsim.ScalingFactors(0.8))
    if change == "stream-sized":
        tcfg = config_from_dict(dataclasses.asdict(
            _jax_cfg("flooding", trials_number=8, batch_size=8)))
        code = _stream_sized_code()
        assert tsim.check_engine(code, tcfg) == match.split()[0]
        generic_stream.reset_counts()
        got = tsim.run_combination(code, comb, tcfg, 0, "cpu")
        assert generic_stream.counts() == (0, 0)
        assert 0.0 < got.ratio_trials_success_decoding <= 1.0
        return
    tcfg = config_from_dict(dataclasses.asdict(_jax_cfg("flooding", **change)))
    with pytest.raises(NotImplementedError, match=match):
        tsim.run_combination(tm, comb, tcfg, 0, "cpu")


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
    assert tsim.check_engine(alist_100k, cfg) == "stream"


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
    (workspace / "configs" / "run.json").write_text(
        json.dumps(_cli_config(enable_code_rate_adaptation=True,
                               code_rate_adaptation_parameters={
                                   "enable_untainted_puncturing": False,
                                   "use_adaptation_parameters_ranges": False,
                                   "code_rate_QBER_adaptation_parameters_maps": [
                                       {"code_rate": 0.5, "QBER": 0.03,
                                        "delta": 0.1, "efficiency": 1.1}],
                               })))
    rc = tcli.main([
        "--configs", str(workspace / "configs"),
        "--matrices", str(workspace / "sparse_matrices"),
        "--results", str(workspace / "results"),
        "--device", "cpu", "--quiet",
    ])
    assert rc == 1
    assert "NotImplementedError" in capsys.readouterr().err


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
