"""The port's stage spans (``utils.span``) on the CPU.

With no profiler recording, a library round and a sweep combination open
no profiler range. Under ``torch.profiler`` (CPU activity) a round records
``protocol.round`` and its stages, a combination ``sim.combination`` and
its stages down to ``channel.*`` and the kernel wrappers' spans, each
inside the span it belongs to; every kernel-wrapper call records one
``kernel.<family>.<mode>`` span per call that its ``KernelCounts`` counts;
a launch plan is built, and recorded, once per code; and results are the
same with the profiler on and off. Two gloo ranks record one
``parallel.step`` a chunk, its ``parallel.reduce`` and the waits inside
it, and the reduction's span lasts as long as the step's own collective
timing says.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qkd_ldpc_v_tpu_torch import protocol as tp
from qkd_ldpc_v_tpu_torch import rate_adapt as tra
from qkd_ldpc_v_tpu_torch import simulation as sim
from qkd_ldpc_v_tpu_torch import utils
from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_ldpc
from qkd_ldpc_v_tpu_torch.ops import (
    fused_generic,
    fused_qc,
    generic_stream,
    launch,
    qc_stream,
    spa,
)

torch.set_num_threads(2)

PREFIXES = ("sim.", "channel.", "kernel.", "protocol.", "parallel.")
QBER = 0.075
CAP = 8
ROUND_STAGES = ["protocol.plan", "protocol.frame", "protocol.syndrome",
                "protocol.decode", "protocol.compare", "protocol.remove"]
GROUP_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def qc_code():
    return generate_qc_ldpc(8, 4, 128, 3, seed=5)


@pytest.fixture(scope="module")
def code(qc_code):
    return qc_code.to_hmatrix()


def _parent(event):
    """The innermost span of the program around a profiler event."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith(PREFIXES):
        p = p.cpu_parent
    return p


def _profiled(fn):
    """``fn()`` under ``torch.profiler``; returns its result and the spans
    as ``[(name, parent span's name or None)]`` in time order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events() if e.name.startswith(PREFIXES)),
                    key=lambda e: e.time_range.start)
    return out, [(e.name, getattr(_parent(e), "name", None)) for e in events]


def _children(spans, parent):
    return [name for name, p in spans if p == parent]


def _config(**kw):
    base = dict(trials_number=6, simulation_seed=5,
                decoding_algorithm=DecodingAlgorithm.NMSA,
                decoding_alg_max_iterations=CAP,
                r_qber_ranges=(RQBERRange(0.99, QBER, QBER, 0.01),),
                batch_size=4, use_pallas=True)
    base.update(kw)
    return Config(**base)


def _combination(code, kind):
    """One combination, two chunks (the second one short): ``keys`` feeds
    a key source to the fused QC trial, ``mc`` takes the mc mode, and
    ``rate_adaptive`` the frame mode."""
    params = tra.HMatrixParams()
    cfg = _config(enable_code_rate_adaptation=kind == "rate_adaptive")
    if kind == "rate_adaptive":
        params = tra.adapt_code_rate(np.random.default_rng(3), code, QBER,
                                     0.1, 1.3)
        tra.finalize_bits_to_remove(code, params, False)
    comb = sim.SimCombination(QBER, params, sim.ScalingFactors(0.8))
    source = sim.default_key_source(5, "cpu") if kind == "keys" else None
    return lambda: sim.run_combination(code, comb, cfg, 1, "cpu",
                                       key_source=source)


def _round(code, rate_adaptive, device="cpu"):
    """A library round with privacy maintenance on 8 frames on
    ``device``."""
    params = None
    if rate_adaptive:
        params = tra.adapt_code_rate(np.random.default_rng(3), code, QBER,
                                     0.1, 1.35)
    spec = tp.make_protocol_spec(code, DecodingAlgorithm.NMSA, CAP, False,
                                 True, params=params)
    gen = torch.Generator().manual_seed(7)
    alice = torch.randint(0, 2, (8, spec.num_key_bits), generator=gen,
                          dtype=torch.int8)
    bob = alice ^ (torch.rand(alice.shape, generator=gen) < 0.02).to(torch.int8)
    alice, bob = alice.to(device), bob.to(device)
    if not rate_adaptive:
        return lambda: tp.qkd_ldpc(spec, alice, bob, 0.02, 0.8)
    punct = torch.randint(0, 2, (8, len(spec.punctured_positions)),
                          generator=gen, dtype=torch.int8).to(device)
    return lambda: tp.qkd_ldpc_rate_adapt(spec, alice, bob, 0.02, None, 0.8,
                                          alice_punct=punct)


def test_no_profiler_opens_no_range(code, monkeypatch):
    calls = []

    def counted(name):
        calls.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(utils, "record_function", counted)
    _round(code, True)()
    _combination(code, "keys")()
    assert calls == []
    # The patch sits where the helper looks: a profiled round calls it.
    _profiled(_round(code, True))
    assert calls[0] == "protocol.round"


@pytest.mark.parametrize("rate_adaptive,warm", [
    (False, False), (True, False), (True, True)],
    ids=["fixed", "rate_adaptive", "rate_adaptive_second_round"])
def test_a_round_records_its_stages(code, rate_adaptive, warm):
    """A spec's first round builds its plan: the index arrays' uploads
    (payload, punctured, shortened and ``keep``; ``keep`` alone at a fixed
    rate) inside ``protocol.plan``. A second round on the spec finds the
    plan and uploads nothing."""
    run = _round(code, rate_adaptive)
    if warm:
        run()
    _, spans = _profiled(run)
    assert [s for s in spans if s[0] == "protocol.round"] == [
        ("protocol.round", None)]
    stages = _children(spans, "protocol.round")
    plan = (["protocol.positions"] * 4 if rate_adaptive
            else ["protocol.positions"])
    if warm:
        assert stages == ROUND_STAGES[1:]
        assert "protocol.positions" not in {name for name, _ in spans}
    else:
        assert stages == ROUND_STAGES
        assert _children(spans, "protocol.plan") == plan
    # The decoder's call, on the CPU its plain version, inside the decode
    # stage; nothing else of the program nests deeper.
    assert _children(spans, "protocol.decode") == [
        "kernel.fused_generic.decode"]
    parents = {None, "protocol.round", "protocol.decode"}
    assert {p for _, p in spans} == (parents if warm
                                     else parents | {"protocol.plan"})


@pytest.mark.parametrize("kind,decode", [
    ("keys", "kernel.fused_qc.trial"),
    ("mc", "kernel.fused_qc.mc"),
    ("rate_adaptive", "kernel.fused_qc.frame"),
])
def test_a_combination_records_its_stages(code, kind, decode):
    _, spans = _profiled(_combination(code, kind))
    assert [s for s in spans if s[0] == "sim.combination"] == [
        ("sim.combination", None)]
    assert _children(spans, "sim.combination") == [
        "sim.step", "sim.chunk", "sim.chunk", "sim.stats"]
    chunk = {"keys": ["sim.keys", "sim.decode", "sim.fetch"],
             "mc": ["sim.decode", "sim.fetch"],
             "rate_adaptive": ["sim.frames", "sim.decode", "sim.fetch"]}[kind]
    assert _children(spans, "sim.chunk") == chunk * 2
    assert _children(spans, "sim.decode") == [decode] * 2
    if kind != "mc":
        assert _children(spans, "sim.keys") == [
            "channel.keys", "channel.inject"] * 2
    if kind == "rate_adaptive":
        assert _children(spans, "sim.frames") == ["sim.keys"] * 2


def _stats_inputs(n, batch=3, seed=1):
    gen = torch.Generator().manual_seed(seed)
    alice = torch.randint(0, 2, (batch, n), generator=gen, dtype=torch.int8)
    bob = alice ^ (torch.rand((batch, n), generator=gen) < 0.02).to(torch.int8)
    return alice, bob


def _calls(module, kind, qc_code, code):
    """(the kernel's family, a call of its ``kind`` wrapper and one of the
    wrapper's ``plain``, each a thunk)."""
    alg = DecodingAlgorithm.NMSA
    on_qc = module in (fused_qc, qc_stream)
    matrix = qc_code if on_qc else code
    prefix = {fused_qc: "fused_qc", qc_stream: "qc_stream",
              fused_generic: "fused_generic",
              generic_stream: "generic_stream"}[module]
    make = getattr(module, {"trial": "make_{}_trial",
                            "mc": "make_{}_montecarlo",
                            "frame": "make_{}_frame_trial",
                            "decode": "make_{}_decoder"}[kind].format(prefix))
    fn = make(matrix, alg, CAP, False)
    n = code.num_bit_nodes
    alice, bob = _stats_inputs(n)
    llr = torch.where(bob == 1, -2.5, 2.5).to(torch.float32)
    syndrome = torch.zeros((3, code.num_check_nodes), dtype=torch.int8)
    factors = (0.8, 1.0, 0.0)
    args = {"trial": (alice, bob, 2.5, *factors),
            "mc": (11, 0, 3, 20, 2.5, *factors),
            "frame": (alice, llr, *factors),
            "decode": (llr, syndrome, *factors)}[kind]
    kw = {"device": "cpu"} if kind == "mc" else {}
    return prefix, [lambda: fn(*args, **kw), lambda: fn.plain(*args, **kw)]


@pytest.mark.parametrize("module,kind", [
    (fused_qc, "trial"), (fused_qc, "mc"), (fused_qc, "frame"),
    (fused_qc, "decode"), (qc_stream, "trial"), (qc_stream, "mc"),
    (qc_stream, "decode"), (fused_generic, "trial"), (fused_generic, "mc"),
    (fused_generic, "frame"), (fused_generic, "decode"),
    (generic_stream, "trial"), (generic_stream, "decode"),
], ids=lambda x: getattr(x, "__name__", x).rsplit(".", 1)[-1])
def test_each_counted_call_is_one_kernel_span(module, kind, qc_code, code):
    family, calls = _calls(module, kind, qc_code, code)
    module.reset_counts()
    _, spans = _profiled(lambda: [call() for call in calls])
    assert module.COUNTS.plain(kind) == len(calls)
    assert [s for s in spans if s[0].startswith("kernel.")] == [
        (f"kernel.{family}.{kind}", None)] * len(calls)


@pytest.mark.parametrize("step", spa.STEPS)
def test_each_counted_spa_step_is_one_kernel_span(step):
    spa.COUNTS.reset()
    x = torch.linspace(-3.0, 3.0, 17)
    _, spans = _profiled(lambda: [spa.spa_step(x, step) for _ in range(2)])
    assert spa.COUNTS.plain(step) == 2
    assert spans == [(f"kernel.spa.{step}", None)] * 2


def test_a_plan_is_built_and_recorded_once_per_code(qc_code):
    built = []
    plan_for = launch.cached_plans(
        lambda code, flags, device: built.append(flags) or object())
    _, first = _profiled(lambda: [plan_for(qc_code, 1, "cpu")
                                  for _ in range(3)])
    _, again = _profiled(lambda: plan_for(qc_code, 1, "cpu"))
    assert built == [1]
    assert first == [("kernel.plan", None)] and again == []


def test_a_second_round_records_no_plan(code):
    one = _round(code, True)
    _profiled(one)
    _, spans = _profiled(one)
    assert "kernel.plan" not in {name for name, _ in spans}
    assert ("protocol.round", None) in spans


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels launch only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_rounds_record_one_span_a_launch_and_one_plan(cuda_device,
                                                           code):
    """On the card: the first round builds the decode mode's plan (one
    ``kernel.plan``), the second finds it; each launches the fused
    generic kernel's decode mode once, inside one span."""
    one = _round(code, True, cuda_device)
    fused_generic.reset_counts()
    spans = [_profiled(one)[1] for _ in range(2)]
    assert fused_generic.COUNTS.launches == 2
    assert fused_generic.COUNTS.plain_on_cuda == 0
    for i, found in enumerate(spans):
        names = [name for name, _ in found]
        assert names.count("kernel.plan") == (1 if i == 0 else 0)
        assert _children(found, "protocol.decode").count(
            "kernel.fused_generic.decode") == 1


@pytest.mark.parametrize("kind", ["keys", "mc", "rate_adaptive"])
def test_a_combination_is_the_same_with_the_profiler_on(code, kind):
    run = _combination(code, kind)
    got, _ = _profiled(run)
    assert dataclasses.asdict(got) == dataclasses.asdict(run())


@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
def test_a_round_is_the_same_with_the_profiler_on(code, rate_adaptive):
    run = _round(code, rate_adaptive)
    got, _ = _profiled(run)
    want = run()
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_record_the_reduction(tmp_path):
    """Each rank's three chunks (23 trials in chunks of 10): one
    ``parallel.step`` each, inside ``sim.chunk``, holding the sync and the
    reduction, whose waits are its only children; the reduction's span
    agrees with the step's collective seconds within 10 %."""
    import pickle

    from tests import torch_parallel_worker as W

    outcomes, _ = W.spawn("spans", f"tcp:127.0.0.1:{_free_port()}", 2,
                          tmp_path, GROUP_TIMEOUT_S)
    failed = [f"rank {r}: rc={rc}\n{err[-3000:]}"
              for r, (rc, err) in enumerate(outcomes) if rc != 0]
    assert not failed, "\n".join(failed)
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        steps, times = got["steps"], got["times"]
        assert len(steps) == len(times) == 3
        for step, (_, collective_s) in zip(steps, times):
            assert step["outer"] == "sim.chunk"
            assert step["inner"] == ["parallel.sync", "parallel.reduce"]
            (waits,) = step["in_reduce"]
            assert waits and set(waits) == {"parallel.wait"}
            (reduce_us,) = step["reduce_us"]
            assert reduce_us == pytest.approx(collective_s * 1e6, rel=0.1)
