"""A tiny sweep and a tiny round through the drivers on the CPU (the port
runs its kernels' plain versions there), the result line's shape, and the
check for forbidden modules."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run
from benchmark.harness import guard

ROOT = Path(__file__).resolve().parents[2]

TINY_SWEEP = {"trials": 48, "chunk": 16, "qber": [0.03, 0.035],
              "compare": {"combinations": 2,
                          "limits": {"frame_mismatch": 0.0, "stats_gap": 0.0}}}
TINY_ROUNDS = {"frames": 16, "pool": 2,
               "compare": {"rounds": 2,
                           "limits": {"frame_mismatch": 0.0, "key_mismatch": 0.0,
                                      "untainted_faults": 0}}}
CAP = {"max_iterations": 30}


def tiny(name, overrides, config_overrides=CAP, **kw):
    return run.run_cell(name, 2**31 + 11, 0.0, False, device="cpu",
                        workload_overrides=overrides,
                        config_overrides=config_overrides, **kw)


def test_a_tiny_sweep_is_correct_and_reports_its_metrics():
    out = tiny("alist10k-sweep", TINY_SWEEP)
    assert out["correct"] is True
    assert out["attempted"] == 96 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["metrics"]["frames_per_s"]["unit"] == "frames/s"
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"frame_mismatch": {"value": 0.0, "limit": 0.0},
                             "stats_gap": {"value": 0.0, "limit": 0.0}}


def test_a_tiny_generator_sweep_is_correct():
    out = tiny("alist100k-sweep",
               dict(TINY_SWEEP, trials=6, chunk=4, qber=[0.025],
                    compare={"combinations": 1, "limits": {
                        "frame_mismatch": 0.0, "stats_gap": 0.0}}))
    assert out["correct"] is True and out["attempted"] == 6


def test_a_tiny_round_is_correct_and_reports_its_tail():
    cells = []
    out = tiny("alist10k-rounds", TINY_ROUNDS, hooks=cells.append)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"round_ms_p95", "setup_s"}
    assert out["attempted"] == len(cells[0].round_ms) >= 1
    # Both specs of the bracket reached the window's sample or the
    # warm-up, and the sampled rounds hold real decodes.
    s, block, res = cells[0].sample[0]
    assert res.iterations.shape == (16,)


def test_rounds_serve_every_spec_equally_often():
    from benchmark.drivers.rounds import schedule

    order = schedule(5, 2, 1000)
    assert order.count(0) == order.count(1) == 500
    assert order != schedule(6, 2, 1000)


def test_forbidden_modules_compare_whole_top_level_names():
    assert guard.forbidden_modules(
        ["qkd_ldpc_v_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(
        ["jax.numpy", "qkd_ldpc_v_tpu.ops.channel", "flax",
         "qkd_ldpc_v_tpu_torch"]) == ["flax", "jax", "qkd_ldpc_v_tpu"]


def test_the_cpu_run_loads_no_jax():
    tiny("alist10k-sweep", dict(TINY_SWEEP, trials=16, qber=[0.03]))
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run; "
            "from benchmark.harness import guard; "
            "run.run_cell('alist10k-sweep', 3, 0.0, False, device='cpu', "
            "workload_overrides={'trials': 16, 'chunk': 16, 'qber': [0.03], "
            "'compare': {'combinations': 1, 'limits': {'frame_mismatch': 0.0, "
            "'stats_gap': 0.0}}}, config_overrides={'max_iterations': 20}); "
            "print(guard.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "alist10k-sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cell_metric_and_config_has_its_file():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    bench = ROOT / "benchmark"
    for c in b["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert (bench / "configs" / data["matrix"]).exists()
    for w in b["workloads"]:
        cell = json.loads((bench / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert (bench / "drivers" / f"{cell['driver']}.py").exists()
    names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", names)) <= names
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_the_manifest_keeps_to_its_formats():
    import re

    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    text = re.compile(r"^[^\t\n]{1,200}$")
    assert 1 <= b["run_seconds"] <= 51
    items = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    assert all(name.match(i["name"]) for i in items)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [i["name"] for i in b[section]]
        assert len(names) == len(set(names))
    for w in b["workloads"]:
        assert name.match(w["config"]) and name.match(w["traffic"])
        assert w["chips"] in (1, 4) and text.match(w["why"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for c in b["configs"]:
        assert text.match(c["source"]) and text.match(c["why"])
        assert len(c["reduced"]) <= 16
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert unit.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e_of = {e["name"]: e for e in b["end_to_end"]}
    for m in b["per_layer"]:
        assert unit.match(m["unit"]) and text.match(m["layer"])
        moves = e2e_of[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moves.get("workloads", [cell])
    for w in b["workloads"]:
        e2e = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024
