"""The port's Monte-Carlo sweep (qkd_ldpc_v_tpu_torch/simulation.py, cli.py)
against the JAX package's.

With a ``key_source`` that replays JAX's chunk streams (``trial_keys`` ->
``generate_keys`` -> ``jax.random.bits``), the port's ``run_combination``
on the CPU must equal JAX's ``run_combination`` (``use_pallas = true``:
the fused Pallas trial kernel in interpret mode) field by field, in both
schedules, and ``write_file`` must write the same bytes. The CLI runs end
to end with ``--device cpu``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, MatrixFormat, RQBERRange
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc, write_qc_matrix
from qkd_ldpc_v_tpu.ops import channel as jch
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
from qkd_ldpc_v_tpu_torch import cli as tcli
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, qc_from_arrays
from qkd_ldpc_v_tpu_torch.ops import fused_qc
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams

torch.set_num_threads(2)

QBER = 0.075  # 76 errors in 1024 bits: some frames fail within the cap


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


@pytest.mark.parametrize("change,match", [
    (dict(use_pallas=False), "use_pallas"),
    (dict(decoding_algorithm=DecodingAlgorithm.SPA), "SPA"),
    (dict(dtype="float64"), "float64"),
    (dict(trace_decoding_alg=True), "traced"),
])
def test_unported_engines_raise(matrices, change, match):
    _, tm = matrices
    tcfg = config_from_dict(dataclasses.asdict(_jax_cfg("flooding", **change)))
    comb = tsim.SimCombination(QBER, TParams(), tsim.ScalingFactors(0.8))
    with pytest.raises(NotImplementedError, match=match):
        tsim.run_combination(tm, comb, tcfg, 0, "cpu")


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
