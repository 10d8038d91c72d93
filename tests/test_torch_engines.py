"""The seam between the callers (``simulation.py``, ``protocol.py``) and the
kernel modules.

  * No kernel module (``ops/fused_qc.py``, ``ops/qc_stream.py``,
    ``ops/fused_generic.py``, ``ops/generic_stream.py``, ``ops/spa.py``)
    imports another; each takes its counters from ``ops/counts.py`` and
    each but ``ops/spa.py`` (whose steps need no launch plan) stands on
    ``ops/launch.py``, which imports none of them and only the plain layers
    below it (a static scan).
  * ``kernels.SIGNATURES`` declares exactly the ``extern "C"`` functions of
    ``csrc/*.cu``, with their argument and return types (the sources are
    parsed; nothing is built).
  * The engine gates run once per code object: two chunk steps and a round
    decoder on one matrix call each gate at most once, and the kept
    verdicts do not keep the matrix alive.

No JAX and no card: the sources are read and the plain versions run.
"""

import ast
import ctypes
import gc
import re
import weakref
from pathlib import Path

import pytest

import qkd_ldpc_v_tpu_torch
from qkd_ldpc_v_tpu_torch import engines, kernels, protocol
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_ldpc

PORT = Path(qkd_ldpc_v_tpu_torch.__file__).resolve().parent
REPO = PORT.parent
ALIST1K = (REPO / "sparse_matrices" / "matrices_alist"
           / "(N=1024,M=256,R=0.75,CW=4,SEED=63).mtrx")
KERNEL_MODULES = ("fused_qc", "qc_stream", "fused_generic", "generic_stream",
                  "spa")
# What ops/launch.py may stand on: the package's plain layers.
LAUNCH_MAY_IMPORT = {"utils", "kernels", "config", "models", "ops.channel",
                     "ops.counts", "ops.decoders", "ops.qc_decoder",
                     "ops.philox"}


def _package_imports(path: Path) -> set:
    """The package modules ``path`` imports, relative to the package
    (``ops.launch``, ``models.qc``, ``kernels``, ...)."""
    prefix = "qkd_ldpc_v_tpu_torch"
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        else:
            continue
        for name in names:
            if name.startswith(prefix + "."):
                found.add(name[len(prefix) + 1:])
    return found


@pytest.mark.parametrize("module", KERNEL_MODULES + ("launch",))
def test_no_kernel_module_imports_another(module):
    imports = _package_imports(PORT / "ops" / f"{module}.py")
    others = {f"ops.{m}" for m in KERNEL_MODULES if m != module}
    assert not {i for i in imports
                if any(i == o or i.startswith(o + ".") for o in others)}
    if module == "launch":
        assert all(i == "ops" or any(i == a or i.startswith(a + ".")
                                     for a in LAUNCH_MAY_IMPORT)
                   for i in imports), imports
    else:
        assert "ops.counts" in imports
        assert ("ops.launch" in imports) == (module != "spa")


_CTYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
           "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_type(decl: str):
    """The ctypes type of one C parameter or return type: ``int*`` is a
    pointer to an int the caller reads back, every other pointer an
    opaque address."""
    decl = decl.replace("const ", "").strip()
    if "*" in decl:
        base = decl.split("*")[0].strip()
        return ctypes.POINTER(ctypes.c_int) if base == "int" else \
            ctypes.c_void_p
    return _CTYPES[decl]


def _extern_c_functions():
    """{name: (argtypes, restype)} of every function defined in an
    ``extern "C"`` block of ``csrc/*.cu``."""
    found = {}
    for src in sorted((PORT / "csrc").glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"',
                                text, re.M | re.S):
            for ret, name, params in re.findall(
                    r"^(int|long long)\s+(\w+)\(([^)]*)\)", block, re.M):
                args = [re.sub(r"\w+$", "", p.strip()) for p in
                        params.split(",") if p.strip()]
                assert name not in found, name
                found[name] = ([_c_type(a) for a in args], _c_type(ret))
    return found


def test_signature_table_equals_the_sources():
    sources = _extern_c_functions()
    assert sorted(kernels.SIGNATURES) == sorted(sources)
    for name, (argtypes, restype) in kernels.SIGNATURES.items():
        assert (list(argtypes), restype) == sources[name], name


def _qc_code():
    return generate_qc_ldpc(8, 4, 128, 3, seed=5).to_hmatrix()


def _alist_code():
    return read_sparse_matrix_alist(ALIST1K)


GATES = ("_qc_fused_gate", "qc_stream_feasible", "generic_feasible",
         "stream_feasible")


@pytest.mark.parametrize("make, qc", [(_qc_code, True), (_alist_code, False)],
                         ids=["qc", "alist"])
def test_each_gate_runs_once_per_code(make, qc, monkeypatch):
    """Two chunk steps (mc and trial) and a round decoder on one code read
    the gates' verdicts, which are made once: the QC gates only for a QC
    code."""
    calls = {gate: 0 for gate in GATES}
    for gate in GATES:
        real = getattr(engines, gate)

        def counted(code, gate=gate, real=real):
            calls[gate] += 1
            return real(code)

        monkeypatch.setattr(engines, gate, counted)
    matrix = make()
    cfg = Config(use_pallas=True, decoding_algorithm=DecodingAlgorithm.NMSA,
                 decoding_alg_max_iterations=20)
    first = tsim.ChunkStep(matrix, cfg, "cpu", 8)
    second = tsim.ChunkStep(matrix, cfg, "cpu", 8,
                            key_source=tsim.default_key_source(1, "cpu"))
    assert first.mc is not None and second.trial is not None
    spec = protocol.make_protocol_spec(matrix, DecodingAlgorithm.NMSA, 20,
                                       False, False)
    protocol.round_decoder(spec)
    assert tsim.select_engine(matrix, cfg) == ("qc" if qc else "generic")
    want = 1 if qc else 0
    assert calls == {"_qc_fused_gate": want, "qc_stream_feasible": want,
                     "generic_feasible": 1, "stream_feasible": 1}


def test_the_verdicts_do_not_pin_their_matrix():
    held = len(engines._VERDICTS._data)
    matrix = _alist_code()
    assert engines.verdicts(matrix) == engines.Verdicts(False, False, True,
                                                        False)
    assert engines.verdicts(matrix) is engines.verdicts(matrix)
    assert len(engines._VERDICTS._data) == held + 1
    ref = weakref.ref(matrix)
    del matrix
    gc.collect()
    assert ref() is None
    assert len(engines._VERDICTS._data) == held
