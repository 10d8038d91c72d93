"""The port's campaign scripts (scripts/fer_campaign_torch.py and
scripts/tune_factors_torch.py) against the JAX package's
(scripts/fer_campaign.py, scripts/tune_factors.py), on the CPU.

  * ``campaign_rows`` on the 1k suite, with JAX's chunk keys fed, equals
    JAX's ``run_combination`` (its XLA engine) at the same Config: the whole
    result, FER and mean iterations included, and the table line.
  * The tuning grids equal the JAX script's (read from its text), and one
    NMSA point on the 1k R=0.72 alist code equals JAX's; ``best`` keeps the
    JAX script's rule.
  * The suites hold the codes, factors and QBER grids of the committed JAX
    tables (40 comparable points), and every committed row formats back to
    itself; ``main`` writes such a table on the CPU.
  * ``--device cuda`` raises without a GPU, and importing either script
    loads no jax.
"""

import ast
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, MatrixFormat, RQBERRange
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.ops import fused_generic
from test_torch_simulation import _jax_key_source

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
ALIST = REPO / "sparse_matrices" / "matrices_alist"
CODE_FILES = {
    "alist 1k R=0.72 CW=4 (committed)": "(N=1024,M=283,R=0.72,CW=4,SEED=6).mtrx",
    "alist 1k R=0.62 CW=3 (committed)": "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx",
}
# Points of the committed JAX tables whose codes are in the repository.
COMPARABLE = {"10k": 10, "1k": 10, "100k": 20}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


fc = _load("fer_campaign_torch")
tf = _load("tune_factors_torch")


@pytest.fixture(scope="module")
def suite_1k():
    return {c.name: c for c in fc.suite_codes("1k")}


def _jax_cfg(seed, qber, trials, alg=DecodingAlgorithm.NMSA):
    return Config(
        trials_number=trials,
        simulation_seed=seed,
        decoding_algorithm=alg,
        decoding_alg_max_iterations=100,
        r_qber_ranges=(RQBERRange(0.99, qber, qber, 0.01),),
        batch_size=trials,
        use_pallas=False,
    )


@pytest.mark.parametrize("qber", [0.025, 0.03])
@pytest.mark.parametrize("name", sorted(CODE_FILES))
def test_campaign_rows_equal_jax_on_the_1k_suite(suite_1k, name, qber):
    code = dataclasses.replace(suite_1k[name], qbers=(qber,))
    assert code.batch == 0
    assert tsim.select_engine(code.matrix, fc.point_config(qber, 128, 0)) == "generic"
    jm = jread_matrix(ALIST / CODE_FILES[name], MatrixFormat.ALIST)
    jcfg = _jax_cfg(fc.SEED, qber, 128)
    assert jsim.pallas_engine(jm, jcfg) == "xla"
    want = jsim.run_combination(
        jm, jsim.SimCombination(qber, JParams(), jsim.ScalingFactors(code.alpha)),
        jcfg, sim_number=0)
    fused_generic.reset_counts()
    (row,) = list(fc.campaign_rows([code], 128, "cpu",
                                   key_source=_jax_key_source(fc.SEED)))
    assert fused_generic.counts() == (0, 0)
    assert (row.name, row.alpha, row.qber) == (name, code.alpha, qber)
    assert dataclasses.asdict(row.result) == dataclasses.asdict(want)
    assert row.fer == 1 - want.ratio_trials_success_ldpc
    assert fc.format_row(name, code.alpha, qber, row.fer,
                         row.result.iter_success_mean) == fc.format_row(
        name, code.alpha, qber, 1 - want.ratio_trials_success_ldpc,
        want.iter_success_mean)


def _jax_grids():
    """The ``grids`` dict of scripts/tune_factors.py, evaluated from its
    text (the script is not imported)."""
    tree = ast.parse((SCRIPTS / "tune_factors.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "grids"):
            return eval(compile(ast.Expression(node.value), "grids", "eval"), {})
    raise AssertionError("no grids in scripts/tune_factors.py")


def test_tune_grids_equal_the_jax_scripts():
    grids = _jax_grids()
    assert tf.GRIDS == grids
    assert [len(g) for g in grids.values()] == [9, 8, 16, 9]
    assert tf.SEED == 31 and tf.CAP == 100
    assert tf.algorithm("SPA-LIN") == tsim.DecodingAlgorithm.SPA_APPROX


def test_tune_row_equals_jax():
    name = "alist 1k R=0.72 CW=4 (committed)"
    tm = fc.read_sparse_matrix_alist(ALIST / CODE_FILES[name])
    jm = jread_matrix(ALIST / CODE_FILES[name], MatrixFormat.ALIST)
    row = next(tf.tune_rows(tm, ["NMSA"], 64, 0.03, "cpu",
                            key_source=_jax_key_source(tf.SEED)))
    prim, sec = tf.GRIDS["NMSA"][0]
    assert (row.alg, row.primary, row.secondary) == ("NMSA", prim, sec)
    want = jsim.run_combination(
        jm, jsim.SimCombination(0.03, JParams(), jsim.ScalingFactors(prim, sec)),
        _jax_cfg(tf.SEED, 0.03, 64), sim_number=0)
    assert 0.0 < want.ratio_trials_success_ldpc < 1.0
    assert dataclasses.asdict(row.result) == dataclasses.asdict(want)
    assert row.line() == (
        f"| NMSA | {prim} | {sec} | {1 - want.ratio_trials_success_ldpc:.5f} "
        f"| {want.iter_success_mean:.1f} |")


def test_best_keeps_the_jax_rule():
    def row(alg, prim, ok, iters):
        res = tsim.SimResult(ratio_trials_success_ldpc=ok,
                             iter_success_mean=iters)
        return tf.TuneRow(alg, prim, 1.0, res, 0.0)

    rows = [row("NMSA", 0.5, 0.9, 10.0), row("NMSA", 0.6, 1.0, 12.0),
            row("NMSA", 0.7, 1.0, 11.0), row("NMSA", 0.8, 1.0, 11.0),
            row("OMSA", 0.1, 0.5, 3.0)]
    got = tf.best(rows)
    assert (got["NMSA"].primary, got["OMSA"].primary) == (0.7, 0.1)


@pytest.mark.parametrize("suite", sorted(COMPARABLE))
def test_suites_hold_the_jax_tables_points(suite):
    want = fc.jax_rows(suite)
    codes = fc.suite_codes(suite)
    points = {(c.name, q): c.alpha for c in codes for q in c.qbers}
    comparable = {k: v for k, v in want.items() if k[0] in {c.name for c in codes}}
    assert len(comparable) == COMPARABLE[suite]
    assert set(comparable) == set(points)
    for key, (alpha, _, _) in comparable.items():
        assert points[key] == alpha
    # The rows left out are the reference's own alist codes.
    assert all(k[0].startswith("reference ") for k in set(want) - set(points))
    batches = {c.name: c.batch for c in codes}
    if suite == "100k":
        assert batches["alist 100k R=0.69 CW=3 (streaming)"] == 4096
        assert {b for n, b in batches.items() if "streamed QC" in n} == {1024}
    else:
        assert set(batches.values()) == {0}


def test_the_100k_alist_rows_come_from_the_committed_matrix_table():
    table, override = fc.JAX_TABLES["100k"]
    rows = fc.read_table(REPO / override)
    name = "alist 100k R=0.69 CW=3 (streaming)"
    assert set(rows) == {(name, q) for q in (0.02, 0.025, 0.03, 0.035, 0.04)}
    assert "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx" in (
        REPO / override).read_text()
    assert fc.jax_rows("100k")[name, 0.02] == rows[name, 0.02]
    assert fc.read_table(REPO / table)[name, 0.02] != rows[name, 0.02]


@pytest.mark.parametrize("table", sorted(t for ts in fc.JAX_TABLES.values()
                                         for t in ts))
def test_committed_rows_format_back_to_themselves(table):
    lines = (REPO / table).read_text().splitlines()
    rows = [ln for ln in lines if ln.startswith("| ")]
    assert tuple(rows[:1] + [lines[lines.index(rows[0]) + 1]]) == fc.TABLE_HEAD
    parsed = fc.read_table(REPO / table)
    assert len(parsed) == len(rows) - 1
    for line in rows[1:]:
        name, q = line.split(" | ")[0][2:], float(line.split(" | ")[2])
        alpha, fer, iters = parsed[name, q]
        assert fc.format_row(name, alpha, q, fer, iters) == line


def test_rules_refuse_a_shift_of_more_than_their_margin():
    assert fc.fer_margin(0.0, 0.0, 4096) == pytest.approx(2 / 4096 + 0.5e-5)
    # The headline QC code at QBER 0.035: 0.11841 against 0.16 is more than
    # 4 standard errors (about 0.0296) apart, 0.14 is not.
    assert abs(0.16 - 0.11841) > fc.fer_margin(0.16, 0.11841, 4096)
    assert abs(0.14 - 0.11841) <= fc.fer_margin(0.14, 0.11841, 4096)
    assert fc.iters_margin(2.0, 4096, 4096) == pytest.approx(
        5 * 2.0 * np.sqrt(2 / 4096) + 0.05)


def test_main_writes_the_table_on_the_cpu(tmp_path):
    out = tmp_path / "t.md"
    assert fc.main(["--suite", "1k", "--trials", "16", "--device", "cpu",
                    "--out", str(out)]) == 0
    text = out.read_text()
    assert "16 trials per point" in text and "the CPU" in text
    rows = fc.read_table(out)
    assert set(rows) == {(c.name, q) for c in fc.suite_codes("1k")
                         for q in c.qbers}
    assert all(0.0 <= fer <= 1.0 for _, fer, _ in rows.values())


def test_tune_main_prints_the_table_on_the_cpu(capsys):
    path = ALIST / CODE_FILES["alist 1k R=0.72 CW=4 (committed)"]
    assert tf.main(["--trials", "16", "--alg", "OMSA", "--matrix", str(path),
                    "--device", "cpu"]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert tuple(lines[:2]) == tf.TABLE_HEAD
    assert len(lines) == 2 + len(tf.GRIDS["OMSA"])
    assert "# best OMSA: primary=" in out.err


@pytest.mark.parametrize("mod", [fc, tf], ids=["fer_campaign", "tune_factors"])
def test_device_cuda_raises_without_a_gpu(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--device", "cuda", "--trials", "8"])


@pytest.mark.parametrize("name", ["fer_campaign_torch", "tune_factors_torch"])
def test_scripts_import_no_jax(name):
    path = SCRIPTS / f"{name}.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "qkd_ldpc_v_tpu"}
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {str(path)!r})\n"
        "mod = sys.modules['m'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'qkd_ldpc_v_tpu')]\n"
        "assert 'qkd_ldpc_v_tpu_torch.simulation' in sys.modules\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
