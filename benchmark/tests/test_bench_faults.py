"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have: a decode that returns its state unchanged,
half of the batch left out (the rest standing in for it), and an answer
altered where it is produced. The exchange between cards does not exist in
these one-card cells. The control (the reference in bfloat16 in the
program's place) comes out not correct through the same run at a small
size, and so does a tainted puncturing list."""

import shutil
from pathlib import Path

import pytest
import torch

from benchmark import control, run
from benchmark.tests.test_bench_drivers import CAP, TINY_ROUNDS, TINY_SWEEP, tiny


def _sweep_fault(kind):
    from qkd_ldpc_v_tpu_torch import simulation

    real = simulation.ChunkStep.decode

    def decode(self, args, chunk_index):
        conv, keys, iters = real(self, args, chunk_index)
        if kind == "unchanged":
            return (torch.zeros_like(conv), torch.zeros_like(keys),
                    torch.full_like(iters, CAP["max_iterations"]))
        if kind == "half":
            h = conv.shape[0] // 2
            conv, keys, iters = (torch.cat([x[:h], x[:h]]) for x in (conv, keys, iters))
            return conv, keys, iters
        iters = iters.clone()
        iters[0] += 1
        return conv, keys, iters

    return simulation.ChunkStep, "decode", decode


def _round_fault(kind):
    from qkd_ldpc_v_tpu_torch import protocol
    from qkd_ldpc_v_tpu_torch.ops.decoders import DecodeResult

    real = protocol.round_decoder

    def round_decoder(spec):
        decode = real(spec)

        def broken(llr, syndrome, *args):
            if kind == "unchanged":
                b = llr.shape[0]
                return DecodeResult((llr <= 0).to(torch.int8),
                                    torch.zeros(b, dtype=torch.bool),
                                    torch.full((b,), spec.max_iterations,
                                               dtype=torch.int32))
            if kind == "half":
                h = llr.shape[0] // 2
                res = decode(llr[:h], syndrome[:h], *args)
                return DecodeResult(*(torch.cat([x, x]) for x in res))
            res = decode(llr, syndrome, *args)
            decision = res.decision.clone()
            decision[0] ^= 1
            return DecodeResult(decision, res.syndromes_match, res.iterations)

        return broken

    return protocol, "round_decoder", round_decoder


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_sweep_is_not_correct(kind, monkeypatch):
    monkeypatch.setattr(*_sweep_fault(kind))
    out = tiny("alist10k-sweep", dict(TINY_SWEEP, qber=[0.03]))
    assert out["correct"] is False
    assert out["checks"]["frame_mismatch"]["value"] > 0.0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_round_is_not_correct(kind, monkeypatch):
    monkeypatch.setattr(*_round_fault(kind))
    out = tiny("alist10k-rounds", TINY_ROUNDS)
    assert out["correct"] is False
    assert out["checks"]["key_mismatch"]["value"] > 0.0


def test_the_sweep_control_fails_the_limits(monkeypatch):
    from qkd_ldpc_v_tpu_torch import simulation

    # The control replaces the decode of every chunk step of the process.
    monkeypatch.setattr(simulation.ChunkStep, "decode",
                        simulation.ChunkStep.decode)
    out = tiny("alist10k-sweep",
               dict(TINY_SWEEP, trials=96, chunk=96, qber=[0.03],
                    compare=dict(TINY_SWEEP["compare"], combinations=1)),
               hooks=control.hooks)
    assert out["correct"] is False
    assert out["checks"]["frame_mismatch"]["value"] > 0.0
    assert out["checks"]["stats_gap"]["value"] > 0.0


def test_the_rounds_control_fails_the_limits():
    out = tiny("alist10k-rounds", dict(TINY_ROUNDS, frames=32),
               hooks=control.hooks)
    assert out["correct"] is False
    assert out["checks"]["frame_mismatch"]["value"] > 0.0


def test_a_tainted_puncturing_list_is_not_correct(tmp_path):
    """The program and the reference both read the .untp beside the
    matrix; a list with two bits on one check passes the frame and key
    comparison and fails the greedy's replay."""
    from benchmark.reference import adapt
    from benchmark.reference.alist import read_alist

    configs = Path(run.__file__).parent / "configs"
    code = read_alist(configs / "alist10k.mtrx")
    listed = adapt.read_untainted(configs / "alist10k.untp")
    first = int(listed[0])
    listed[1] = next(int(b) for b in code.rows[code.cols[first][0]] if b != first)
    shutil.copy(configs / "alist10k.mtrx", tmp_path / "alist10k.mtrx")
    (tmp_path / "alist10k.untp").write_text(" ".join(map(str, listed)) + " ")
    out = tiny("alist10k-rounds", TINY_ROUNDS, config_overrides=dict(
        CAP, matrix=str(tmp_path / "alist10k.mtrx"),
        untainted=str(tmp_path / "alist10k.untp")))
    assert out["correct"] is False
    assert out["checks"]["untainted_faults"]["value"] > 0
