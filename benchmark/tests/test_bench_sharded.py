"""The sharded sweep on the CPU: four gloo ranks in four processes, each
running the cell as ``run.py`` runs a rank, at a tiny size. Sound, the
combined statistics equal the reference's; with the exchange between the
ranks left out, a rank's answer altered, or the control in the program's
place, the run is not correct. Through ``run.main``, as on the cards, a
rank that loaded JAX leaves rank 0 without a result."""

import json
import multiprocessing
import socket
import subprocess
import sys
import types
from pathlib import Path

import pytest

WORLD = 4
TINY = {"trials": 64, "chunk": 32, "qber": [0.03],
        "compare": {"combinations": 1, "limits": {"stats_gap": 1e-9}}}
CAP = {"max_iterations": 20}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, address, fault, queue):
    import torch

    from benchmark import control, run

    hooks = control.hooks if fault == "control" else None
    if fault == "exchange":
        from qkd_ldpc_v_tpu_torch.parallel import driver

        driver._all_reduce = lambda t, op, mesh: None
    elif fault == "altered" and rank == 1:
        from qkd_ldpc_v_tpu_torch import simulation

        real = simulation.ChunkStep.decode

        def decode(self, args, chunk_index):
            conv, keys, iters = real(self, args, chunk_index)
            iters = iters.clone()
            iters[conv.nonzero()[0]] += 1  # a converged frame's count
            return conv, keys, iters

        simulation.ChunkStep.decode = decode
    torch.set_num_threads(1)
    out = run.run_cell("alist10k-sweep-4x", 2**31 + 23, 0.0, False,
                       device="cpu", workload_overrides=TINY,
                       config_overrides=CAP, rank=rank, world=WORLD,
                       address=address, hooks=hooks)
    queue.put((rank, out))


def run_ranks(fault=None):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    address = f"localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, address, fault, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    outs = dict(queue.get(timeout=600) for _ in range(WORLD))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
        assert p.exitcode == 0
    return outs[0]


def test_four_ranks_equal_the_reference():
    out = run_ranks()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 64
    assert set(out["metrics"]) == {"frames_per_s.sharded", "setup_s"}
    assert out["checks"]["stats_gap"]["value"] < 1e-12


@pytest.mark.parametrize("fault", ["exchange", "altered", "control"])
def test_a_broken_exchange_or_answer_is_not_correct(fault):
    out = run_ranks(fault)
    assert out["correct"] is False


SEED = 2**31 + 29


def on_cpu(run, planted: int) -> None:
    """``run.main`` on the CPU at the tiny size: the look for cards passes,
    and the rank ``planted`` loads a module named ``jax`` in its run."""
    real = run.run_cell

    def run_cell(name, seed, seconds, trace, rank=0, **kw):
        out = real(name, seed, seconds, trace, device="cpu",
                   workload_overrides=TINY, config_overrides=CAP, rank=rank,
                   **kw)
        if rank == planted:
            sys.modules["jax"] = types.ModuleType("jax")
        return out

    run.card.require = lambda torch, chips: None
    run.run_cell = run_cell


def rank_process(argv, planted: int) -> int:
    """A rank other than 0, started by rank 0's ``run.main``."""
    import torch

    from benchmark import run

    torch.set_num_threads(1)
    on_cpu(run, planted)
    return run.main(argv)


def lead_process(planted: int) -> int:
    """Rank 0: ``run.main``, its ranks started as processes that run
    ``rank_process``."""
    import torch

    from benchmark import run

    torch.set_num_threads(1)
    on_cpu(run, planted)

    def start_ranks(args, world, address, script):
        return [subprocess.Popen(
            [sys.executable, "-c", RANK, str(planted), "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace), "--rank",
             str(rank), "--address", address],
            stdout=subprocess.DEVNULL) for rank in range(1, world)]

    run._start_ranks = start_ranks
    return run.main(["--workload", "alist10k-sweep-4x", "--seed", str(SEED),
                     "--seconds", "0", "--trace", "0"])


ROOT = Path(__file__).resolve().parents[2]
PRELUDE = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
           "from benchmark.tests import test_bench_sharded as t; ")
RANK = PRELUDE + "sys.exit(t.rank_process(sys.argv[2:], int(sys.argv[1])))"
LEAD = PRELUDE + "sys.exit(t.lead_process(int(sys.argv[1])))"


@pytest.mark.parametrize("planted", [-1, 2])
def test_a_rank_that_loaded_jax_leaves_no_result(planted):
    done = subprocess.run([sys.executable, "-c", LEAD, str(planted)],
                          capture_output=True, text=True, timeout=600)
    if planted < 0:
        assert done.returncode == 0, done.stderr[-2000:]
        assert json.loads(done.stdout.splitlines()[-1])["correct"] is True
    else:
        assert done.returncode != 0
        assert "{" not in done.stdout
        assert "loaded jax" in done.stderr
