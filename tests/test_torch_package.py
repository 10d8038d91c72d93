"""The port package stands alone, and its host-side copies equal the JAX
package's originals.

  * No module of qkd_ldpc_v_tpu_torch imports jax or qkd_ldpc_v_tpu,
    checked by a static scan and by importing the port in a subprocess.
  * parse_config_data gives the same Config for every configs/*.json.
  * QC code generation and the committed headline asset agree exactly.
  * The rate-based lookups of the sweep agree on every config.
"""

import ast
import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import qkd_ldpc_v_tpu_torch
from qkd_ldpc_v_tpu import config as jconfig
from qkd_ldpc_v_tpu.models import hmatrix as jhmatrix
from qkd_ldpc_v_tpu.models import qc as jqc
from qkd_ldpc_v_tpu_torch import config as tconfig
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, qc_from_arrays
from qkd_ldpc_v_tpu_torch.models import hmatrix as thmatrix
from qkd_ldpc_v_tpu_torch.models import qc as tqc

REPO = Path(__file__).resolve().parent.parent
PORT = Path(qkd_ldpc_v_tpu_torch.__file__).resolve().parent
HEADLINE = (REPO / "sparse_matrices" / "matrices_qc"
            / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
QC1K = (REPO / "sparse_matrices" / "matrices_qc"
        / "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx")


def _port_modules():
    return sorted(PORT.rglob("*.py"))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_static_scan_finds_no_jax_import():
    mods = _port_modules()
    assert len(mods) >= 12
    # The modules of the rate-adaptive, mc, library and multi-device
    # slices, the card smoke script, the two examples and the ranks' worker
    # of the distribution tests.
    names = {str(p.relative_to(PORT)) for p in mods}
    assert {"rate_adapt.py", "privacy.py", "simulation.py",
            "ops/channel.py", "ops/philox.py", "protocol.py", "tracing.py",
            "oracle.py", "parallel/driver.py", "parallel/__init__.py"} <= names
    for path in mods + [REPO / "chip_smoke.py",
                        REPO / "examples" / "qkd_ldpc_example_torch.py",
                        REPO / "examples" / "sharded_sweep_torch.py",
                        REPO / "tests" / "torch_parallel_worker.py"]:
        roots = _imported_roots(path)
        assert "jax" not in roots, path
        assert "jaxlib" not in roots, path
        assert "qkd_ldpc_v_tpu" not in roots, path


def test_import_in_subprocess_loads_no_jax():
    names = [
        "qkd_ldpc_v_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in _port_modules() if p.name not in ("__init__.py", "__main__.py")
    ]
    assert "qkd_ldpc_v_tpu_torch.parallel.driver" in names
    names.append("qkd_ldpc_v_tpu_torch.parallel")
    code = (
        "import importlib, sys\n"
        "import qkd_ldpc_v_tpu_torch\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'qkd_ldpc_v_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _plain(value):
    """asdict output with enums by value, comparable across packages."""
    if isinstance(value, enum.Enum):
        return int(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_parse_config_matches_jax(path):
    jc = jconfig.parse_config_data(path)
    tc = tconfig.parse_config_data(path)
    assert _plain(dataclasses.asdict(tc)) == _plain(dataclasses.asdict(jc))
    assert config_from_dict(dataclasses.asdict(jc)) == tc


def test_generate_qc_peg_headline_identical():
    j = jqc.generate_qc_peg(20, 6, 512, 4, seed=9)
    t = tqc.generate_qc_peg(20, 6, 512, 4, seed=9)
    np.testing.assert_array_equal(t.shifts, j.shifts)
    assert t.lifting == j.lifting == 512
    # ... and it is the committed headline asset.
    np.testing.assert_array_equal(tqc.read_qc_matrix(HEADLINE).shifts, t.shifts)


@pytest.mark.parametrize("path", [HEADLINE, QC1K], ids=["headline", "qc1k"])
def test_write_qc_matrix_writes_the_jax_bytes(path, tmp_path):
    """The port's writer writes the JAX package's bytes (the committed
    asset's), and the file reads back identically through both readers."""
    qc = tqc.read_qc_matrix(path)
    tqc.write_qc_matrix(qc, tmp_path / "torch.mtrx")
    jqc.write_qc_matrix(jqc.read_qc_matrix(path), tmp_path / "jax.mtrx")
    data = (tmp_path / "torch.mtrx").read_bytes()
    assert data == (tmp_path / "jax.mtrx").read_bytes() == path.read_bytes()
    for reader in (tqc.read_qc_matrix, jqc.read_qc_matrix):
        back = reader(tmp_path / "torch.mtrx")
        np.testing.assert_array_equal(back.shifts, qc.shifts)
        assert back.lifting == qc.lifting


def test_generate_qc_ldpc_identical():
    j = jqc.generate_qc_ldpc(8, 4, 128, 3, seed=5)
    t = tqc.generate_qc_ldpc(8, 4, 128, 3, seed=5)
    np.testing.assert_array_equal(t.shifts, j.shifts)


@pytest.mark.parametrize("path", [HEADLINE, QC1K], ids=["headline", "qc1k"])
def test_qc_assets_read_identically(path):
    j = jhmatrix.read_matrix(path, jconfig.MatrixFormat.QC)
    t = thmatrix.read_matrix(path, tconfig.MatrixFormat.QC)
    np.testing.assert_array_equal(t.qc.shifts, j.qc.shifts)
    assert t.qc.lifting == j.qc.lifting
    assert t.is_regular == j.is_regular
    assert (t.num_bit_nodes, t.num_check_nodes) == (j.num_bit_nodes,
                                                    j.num_check_nodes)
    for a, b in zip(t.check_nodes, j.check_nodes):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.bit_nodes, j.bit_nodes):
        np.testing.assert_array_equal(a, b)
    assert qc_from_arrays(j.qc.shifts, j.qc.lifting).shifts.tolist() == \
        t.qc.shifts.tolist()


def test_qc_file_read_as_alist_raises_in_both_packages():
    with pytest.raises(jhmatrix.MatrixFormatError) as jerr:
        jhmatrix.read_matrix(HEADLINE, jconfig.MatrixFormat.ALIST)
    with pytest.raises(thmatrix.MatrixFormatError) as terr:
        thmatrix.read_matrix(HEADLINE, tconfig.MatrixFormat.ALIST)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("code_rate", [0.35, 0.5, 0.62, 0.7, 0.85, 0.93, 0.995])
def test_rate_based_lookups_match_jax(code_rate):
    from qkd_ldpc_v_tpu import simulation as jsim
    from qkd_ldpc_v_tpu_torch import simulation as tsim

    def outcome(fn, *args):
        try:
            r = fn(*args)
        except (jsim.SimulationError, tsim.SimulationError) as e:
            return ("error", str(e))
        if isinstance(r, list):  # QBERAdaptationParameters entries
            return [dataclasses.asdict(x) for x in r]
        return _plain(r)

    for path in sorted((REPO / "configs").glob("*.json")):
        jc = jconfig.parse_config_data(path)
        tc = tconfig.parse_config_data(path)
        pairs = [
            ("rate_based_qber_range", jc.r_qber_ranges, tc.r_qber_ranges),
            ("rate_based_adapt_parameters_ranges", jc.r_adapt_params_ranges,
             tc.r_adapt_params_ranges),
            ("rate_based_qber_adapt_parameters_maps",
             jc.r_qber_adapt_params_maps, tc.r_qber_adapt_params_maps),
            ("rate_based_scaling_factor_value", jc.primary.maps,
             tc.primary.maps),
        ]
        for name, jarg, targ in pairs:
            want = outcome(getattr(jsim, name), code_rate, jarg)
            got = outcome(getattr(tsim, name), code_rate, targ)
            assert got == want, (path.name, name)
        if tc.primary.use_range:
            assert (tsim.scaling_factor_range_values(tc.primary.range)
                    == jsim.scaling_factor_range_values(jc.primary.range))
