"""The port's CLI (qkd_ldpc_v_tpu_torch/cli.py), its checkpoint and resume
(simulation.py) and ``--profile``, with ``--device cpu`` throughout; the
counterpart of tests/test_cli.py.

  * End to end on an alist workspace, a missing configs directory, and
    ``--help-config``.
  * The campaign fingerprint is stable and changes with
    ``tpu.force_engine``, ``tpu.batch_size`` and ``tpu.use_pallas``; a
    checkpoint round-trips every ``SimResult`` field, NumPy scalars
    included; a foreign fingerprint is ignored.
  * A sweep stopped after its first combination (a progress callback that
    raises) and then resumed runs only the rest and writes the same CSV
    rows as an uninterrupted one; the checkpoint is deleted once the CSV
    has landed.
  * ``--profile DIR`` writes a Chrome trace of the run.
  * ``examples/qkd_ldpc_example_torch.py --device cpu`` runs, and its
    oracle section equals ``examples/qkd_ldpc_example.py``'s.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import cli as tcli
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import parse_config_data
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import write_alist
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_ldpc, write_qc_matrix

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _config(**overrides):
    cfg = {
        "threads_number": 1,
        "trials_number": 8,
        "use_config_simulation_seed": True,
        "simulation_seed": 7,
        "enable_privacy_maintenance": False,
        "enable_throughput_measurement": True,
        "throughput_measurement_parameters": {"consider_RTT": True, "RTT": 0.4},
        "decoding_algorithm": 0,
        "decoding_algorithm_max_iterations": 30,
        "matrix_format": 1,
        "trace_qkd_ldpc": False,
        "trace_decoding_algorithm": False,
        "trace_decoding_algorithm_llr": False,
        "enable_decoding_algorithm_msg_llr_threshold": False,
        "code_rate_QBER_ranges": [
            {"code_rate": 0.9, "QBER": {"begin": 0.02, "end": 0.04, "step": 0.01}}
        ],
        "enable_code_rate_adaptation": False,
    }
    cfg.update(overrides)
    return cfg


# Workspaces: the alist code of tests/test_cli.py with its reference-schema
# config (SPA, the xla engine's plain path), and the 1k QC code with NMSA in
# 8-frame chunks (the fused QC kernel's mc plain version).
WORKSPACES = {
    "alist": dict(),
    "qc": dict(matrix_format=4, trials_number=12, decoding_algorithm=2,
               min_sum_normalized_parameters={
                   "use_alpha_range": False,
                   "code_rate_alpha_maps": [{"code_rate": 0.99, "alpha": 0.65}]},
               code_rate_QBER_ranges=[{"code_rate": 0.99, "QBER": {
                   "begin": 0.06, "end": 0.08, "step": 0.01}}],
               tpu={"batch_size": 8, "use_pallas": True, "schedule": "layered"}),
}


def _workspace(root, kind="alist", **overrides):
    configs = root / "configs"
    configs.mkdir(parents=True)
    (configs / "run.json").write_text(
        json.dumps(_config(**{**WORKSPACES[kind], **overrides})))
    if kind == "alist":
        matrices = root / "sparse_matrices" / "matrices_alist"
        matrices.mkdir(parents=True)
        write_alist(generate_regular_ldpc(num_bits=128, num_checks=64,
                                          column_weight=3, seed=5),
                    matrices / "(N=128,M=64).mtrx")
    else:
        matrices = root / "sparse_matrices" / "matrices_qc"
        matrices.mkdir(parents=True)
        write_qc_matrix(generate_qc_ldpc(8, 4, 128, 3, seed=5),
                        matrices / "(N=1024,M=512,Z=128).mtrx")
    return root


def _run(root, *extra, results="results"):
    return tcli.main([
        "--configs", str(root / "configs"),
        "--matrices", str(root / "sparse_matrices"),
        "--results", str(root / results),
        "--device", "cpu", "--quiet", *extra,
    ])


def _rows(results_dir):
    """The CSV's lines, the throughput columns left out."""
    csvs = list(Path(results_dir).glob("*.csv"))
    assert len(csvs) == 1, csvs
    lines = [line.split(";") for line in csvs[0].read_text().splitlines()]
    drop = {i for i, name in enumerate(lines[0]) if name.startswith("THROUGHPUT")}
    assert drop
    return [[v for i, v in enumerate(line) if i not in drop] for line in lines]


def test_cli_end_to_end(tmp_path, capsys):
    root = _workspace(tmp_path)
    rc = _run(root)
    out = capsys.readouterr().out
    assert rc == 0, out
    csvs = list((root / "results").glob("*.csv"))
    assert len(csvs) == 1
    lines = csvs[0].read_text().splitlines()
    assert len(lines) == 4  # header + 3 QBER points
    assert "THROUGHPUT_MEAN" in lines[0]
    assert "CONFIG #1 INFO" in out
    assert "successfully completed" in out
    assert not list((root / "results").glob(".*checkpoint*"))


def test_cli_missing_configs_dir(tmp_path, capsys):
    rc = tcli.main(["--configs", str(tmp_path / "nope"), "--device", "cpu"])
    assert rc == 1
    assert "ERROR" in capsys.readouterr().err


def test_cli_help_config(capsys):
    rc = tcli.main(["--help-config"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "decoding_algorithm" in out
    assert "matrix_format" in out
    assert "trace_decoding_algorithm" in out
    assert "NotImplementedError" not in out


def _sim_inputs(tmp_path, kind="qc", **overrides):
    root = _workspace(tmp_path, kind, **overrides)
    cfg = parse_config_data(root / "configs" / "run.json")
    sub = "matrices_qc" if kind == "qc" else "matrices_alist"
    paths = sorted((root / "sparse_matrices" / sub).glob("*.mtrx"))
    return tsim.prepare_sim_inputs(paths, cfg), cfg


@pytest.mark.parametrize("change", [
    dict(force_engine="qc_stream"),
    dict(batch_size=4),
    dict(use_pallas=False),
], ids=["force_engine", "batch_size", "use_pallas"])
def test_fingerprint_changes_with_engine_fields(tmp_path, change):
    sim_inputs, cfg = _sim_inputs(tmp_path)
    fp = tsim._campaign_fingerprint(sim_inputs, cfg)
    assert fp == tsim._campaign_fingerprint(sim_inputs, cfg)
    assert len(fp) == 16
    assert tsim._campaign_fingerprint(
        sim_inputs, dataclasses.replace(cfg, **change)) != fp


def test_fingerprint_is_stable_across_preparations(tmp_path):
    a, cfg = _sim_inputs(tmp_path / "a")
    b, _ = _sim_inputs(tmp_path / "b")
    # The same matrix file under another path is another campaign.
    assert tsim._campaign_fingerprint(a, cfg) != tsim._campaign_fingerprint(b, cfg)
    a2 = tsim.prepare_sim_inputs([s.matrix_path for s in a], cfg)
    assert tsim._campaign_fingerprint(a2, cfg) == tsim._campaign_fingerprint(a, cfg)


def test_checkpoint_round_trip_and_foreign_fingerprint(tmp_path):
    sim_inputs, cfg = _sim_inputs(tmp_path, enable_throughput_measurement=True)
    results = tsim.qkd_ldpc_batch_simulation(sim_inputs, cfg, "cpu")
    # NumPy scalars, as the sweep's arithmetic can leave them, serialise.
    results[0].config_qber = np.float32(results[0].config_qber)
    results[0].is_regular = np.bool_(results[0].is_regular)
    results[0].iter_success_max = np.int64(results[0].iter_success_max)
    path = tmp_path / "ckpt.json"
    tsim.save_checkpoint(path, "abc", results)
    loaded = tsim.load_checkpoint(path, "abc")
    assert [dataclasses.asdict(r) for r in loaded] == \
        [dataclasses.asdict(r) for r in results]
    assert all(type(v) in (int, float, bool, str, dict)
               for v in dataclasses.asdict(loaded[0]).values())
    assert tsim.load_checkpoint(path, "other") == []
    assert tsim.load_checkpoint(tmp_path / "absent.json", "abc") == []
    path.write_text("{not json")
    assert tsim.load_checkpoint(path, "abc") == []


@pytest.mark.parametrize("kind", list(WORKSPACES))
def test_resumed_sweep_writes_the_uninterrupted_rows(tmp_path, kind, capsys,
                                                     monkeypatch):
    full = _workspace(tmp_path / "full", kind)
    assert _run(full) == 0
    want = _rows(full / "results")
    assert len(want) == 4

    root = _workspace(tmp_path / "resumed", kind)
    trials = parse_config_data(root / "configs" / "run.json").trials_number
    printer = tcli._progress_printer

    def stop_after_first(quiet):
        done = [0]

        def cb(inc, total):
            done[0] += inc
            if done[0] > trials:
                raise KeyboardInterrupt
        return cb

    monkeypatch.setattr(tcli, "_progress_printer", stop_after_first)
    with pytest.raises(KeyboardInterrupt):
        _run(root)
    checkpoint = root / "results" / ".run.checkpoint.json"
    assert len(json.loads(checkpoint.read_text())["results"]) == 1
    assert not list((root / "results").glob("*.csv"))

    monkeypatch.setattr(tcli, "_progress_printer", printer)
    ran = []
    run_combination = tsim.run_combination

    def counted(*args, **kwargs):
        ran.append(args[3])
        return run_combination(*args, **kwargs)

    monkeypatch.setattr(tsim, "run_combination", counted)
    assert _run(root) == 0
    assert ran == [1, 2]
    assert _rows(root / "results") == want
    assert not checkpoint.exists()


def test_profile_writes_a_trace(tmp_path, capsys):
    root = _workspace(tmp_path, "qc")
    assert _run(root, "--profile", str(tmp_path / "prof")) == 0
    trace = tmp_path / "prof" / "trace.json"
    assert str(trace) in capsys.readouterr().out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert tcli._kernel_events(trace) == 0  # the CPU run launches no kernel


def _oracle_section(text):
    return text.split("=== Batched")[0]


def test_example_runs_on_the_cpu_and_prints_the_oracle_trajectory():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    run = [subprocess.run([sys.executable, str(REPO / "examples" / name),
                           *args], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
           for name, args in (("qkd_ldpc_example_torch.py", ["--device", "cpu"]),
                              ("qkd_ldpc_example.py", []))]
    for proc in run:
        assert proc.returncode == 0, proc.stderr
    got, want = (proc.stdout for proc in run)
    assert "Keys matched: YES" in got
    assert "device decode matches the reference-exact trajectory." in got
    assert _oracle_section(got) == _oracle_section(want)
