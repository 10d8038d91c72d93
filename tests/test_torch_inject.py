"""The exact error injection's select kernel (``csrc/inject.cu``) on the
card, held bit for bit to its plain version (``channel.plain_inject_errors``:
int64 keys and ``torch.kthvalue``) and to NumPy's lexsort.

  * The hard words of ``inject_cases`` (equal words, words in one bin of
    the kernel's first histogram, the unsigned order's edges) at no, one, a
    third, all but one and all errors, N = 1000 and 4099, both key widths:
    one launch a call, no plain call on the card.
  * A main-path chunk of the 100k alist sweep (4096 frames of 102400 bits,
    torch-generator keys, the streamed generic trial kernel) at each QBER
    of the benchmark's ``alist100k-sweep`` cell: one launch of the select
    kernel, recorded as one ``kernel.channel.inject`` span inside
    ``channel.inject``, none of its plain version, and Bob's keys equal to
    the plain version's on the same draw. The kernel's device event names
    (by the trace's ``External id``) its launching host operator,
    ``qkd_ldpc_v_tpu_torch::inject_select``, which starts inside
    ``channel.inject``: what a reader of the channel's device time links.

They skip without a card and import no JAX:

    python -m pytest tests/test_torch_inject.py -m cuda --noconftest -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm, MatrixFormat
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
from qkd_ldpc_v_tpu_torch.ops import channel as tch
from qkd_ldpc_v_tpu_torch.ops import generic_stream

import inject_cases  # tests/inject_cases.py: pytest puts tests/ on the path

ALIST_100K = (Path(__file__).resolve().parents[1] / "sparse_matrices"
              / "matrices_alist" / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx")
CHUNK = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the select kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("which", inject_cases.COUNTS)
@pytest.mark.parametrize("wide", [True, False], ids=["wide", "narrow"])
@pytest.mark.parametrize("n", inject_cases.SIZES)
@pytest.mark.parametrize("kind", inject_cases.KINDS)
def test_card_kernel_equals_plain_on_hard_words(cuda_device, kind, n, wide,
                                                which):
    words = inject_cases.words(kind, 3, n, seed=n)
    alice = np.random.default_rng(1).integers(0, 2, (3, n), dtype=np.int8)
    num_errors = inject_cases.error_count(which, n)
    w, a = (torch.tensor(x, device=cuda_device) for x in (words, alice))
    tch.INJECT_COUNTS.reset()
    bob = tch.inject_errors(w, a, num_errors, wide)
    torch.cuda.synchronize()
    assert tch.INJECT_COUNTS.get() == (1, 0)
    want = tch.plain_inject_errors(w, a, num_errors, wide)
    assert torch.equal(bob, want)
    np.testing.assert_array_equal(
        bob.cpu().numpy() ^ alice,
        inject_cases.expected_flips(words, num_errors, wide))


def _launching_ops(path, kernel, span):
    """For each device event of a Chrome trace whose name holds ``kernel``:
    the name of the host operator its ``External id`` names, and whether
    that operator starts inside a ``span`` annotation."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == span]
    found = []
    for e in events:
        if e.get("cat") == "kernel" and kernel in e["name"]:
            op = ops.get(e.get("args", {}).get("External id"))
            found.append((op and op["name"],
                          bool(op) and any(s <= op["ts"] <= t
                                           for s, t in spans)))
    return found


@pytest.fixture(scope="module")
def alist100k():
    return read_matrix(ALIST_100K, MatrixFormat.ALIST)


@pytest.mark.cuda
@pytest.mark.parametrize("qber", [0.02, 0.025, 0.03, 0.035])
def test_card_main_path_chunk_launches_the_kernel_once(cuda_device,
                                                       alist100k, qber,
                                                       tmp_path):
    n = alist100k.num_bit_nodes
    cfg = Config(trials_number=CHUNK, simulation_seed=2024,
                 decoding_algorithm=DecodingAlgorithm.NMSA,
                 decoding_alg_max_iterations=100,
                 matrix_format=MatrixFormat.ALIST, batch_size=CHUNK,
                 use_pallas=True)
    step = tsim.ChunkStep(alist100k, cfg, cuda_device, CHUNK)
    num_errors = tch.exact_error_count(n, qber)
    args = tsim.ChunkArgs(sim_number=3, num_errors=num_errors,
                          log_p=tch.log_ratio(num_errors / n),
                          scalars=(0.8, 1.0, 0.0))
    tch.INJECT_COUNTS.reset()
    generic_stream.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(args, 0, CHUNK)
    assert tch.INJECT_COUNTS.get() == (1, 0)
    launches = [e for e in prof.events() if e.name == tch.INJECT_SPAN
                and e.device_type == DeviceType.CPU]
    assert len(launches) == 1
    assert launches[0].cpu_parent.name == "channel.inject"
    prof.export_chrome_trace(str(tmp_path / "chunk.json"))
    assert _launching_ops(tmp_path / "chunk.json", "inject_select_kernel",
                          "channel.inject") == [
        ("qkd_ldpc_v_tpu_torch::inject_select", True)]
    assert generic_stream.COUNTS.launches == 1
    assert generic_stream.COUNTS.plain_on_cuda == 0

    alice, bob, _ = step.chunk_keys(args, 0)
    same_alice, words = step.source(3, 0, CHUNK, n)
    want = tch.plain_inject_errors(words, same_alice, num_errors, True)
    assert torch.equal(alice, same_alice)
    assert torch.equal(bob, want)
    assert ((bob ^ alice).sum(dim=1) == num_errors).all()
