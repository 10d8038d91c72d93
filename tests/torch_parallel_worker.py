"""One rank of a gloo group on the CPU, for tests/test_torch_parallel.py and
tests/test_torch_distributed.py (the port's counterpart of
tests/distributed_worker.py).

Not a test module. Run as

    python tests/torch_parallel_worker.py MODE INIT WORLD RANK OUT

  * MODE ``cases``: every sharded case of test_torch_parallel.py, in a
    group of 4 ranks with a subgroup of ranks 0 and 1 for the world-2
    cases: gathered and reduce-mode runs of ``run_combination`` through
    ``mesh_step_factory`` (``RUNS``), ``psum_stats`` over 4 ranks, the
    edge-sharded decoder, and the rank-0 checkpoint writer;
  * MODE ``reduce``: the two-process run of test_torch_distributed.py, the
    reduce-mode ``sharded_step`` (SPA, 16 trials, 13 counted) and the same
    chunk gathered;
  * MODE ``fail``: rank 1 raises after the group is up, rank 0 enters a
    collective, which must fail within the group's timeout;
  * MODE ``spans``: the two-process run of test_torch_spans.py, a
    reduce-mode combination through ``mesh_step_factory`` under
    ``torch.profiler``: each rank's ``parallel.*`` spans and its step's
    ``times``.

INIT is ``file:PATH`` (a ``FileStore``, no port to race for) or
``tcp:HOST:PORT`` (``initialize_distributed``). Each rank writes its
results to ``OUT/rank{RANK}.pkl``. The worker imports torch and the port,
never JAX, and runs on one CPU thread.
"""

import dataclasses
import functools
import math
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from qkd_ldpc_v_tpu_torch import simulation as sim  # noqa: E402
from qkd_ldpc_v_tpu_torch.config import (  # noqa: E402
    Config,
    DecodingAlgorithm,
    RQBERRange,
)
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc  # noqa: E402
from qkd_ldpc_v_tpu_torch.models.layout import layout_for  # noqa: E402
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_peg  # noqa: E402
from qkd_ldpc_v_tpu_torch.ops.channel import (  # noqa: E402
    calculate_syndrome,
    exact_error_count,
    log_ratio,
)
from qkd_ldpc_v_tpu_torch.parallel import driver  # noqa: E402
from qkd_ldpc_v_tpu_torch.rate_adapt import (  # noqa: E402
    HMatrixParams,
    adapt_code_rate,
    finalize_bits_to_remove,
)

INIT_TIMEOUT_S = 60

# name -> (code, QBER, config fields, scaling factors). 23 trials in chunks
# of 10: a short final chunk, and trials divisible by neither world size;
# at these QBERs some frames fail within the cap.
RUNS = {
    "qc": ("qc", 0.08, dict(schedule="layered"), (0.8,)),
    "qc_stream": ("qc", 0.08, dict(force_engine="qc_stream"), (0.8,)),
    "generic": ("medium", 0.075, {}, (0.8,)),
    "stream": ("stream", 0.07, dict(force_engine="stream"), (0.8,)),
    "xla": ("medium", 0.075, dict(use_pallas=False), (0.8,)),
    "rate_adaptive": ("qc", 0.08, dict(enable_code_rate_adaptation=True),
                      (0.8,)),
}
MC_RUNS = ("qc", "qc_stream", "generic")
WORLDS = (2, 4)
SIM_NUMBER = 1

# The edge-sharded decoder's case: the medium code, NMSA cap 30, QBER 0.03.
EDGE_FRAMES = 16
EDGE_QBER = 0.03
EDGE_DTYPES = (torch.float32, torch.float64)

# psum_stats over 4 ranks: 64 frames, 16 a rank.
PSUM_FRAMES = 64

# The reduce-mode sharded step of test_torch_distributed.py.
REDUCE_TRIALS = 16
REDUCE_TAKE = 13


@functools.lru_cache(maxsize=None)
def matrix_of(code):
    """"qc": the 8x4x128 QC code; "medium": the conftest's medium code;
    "stream": a column-weight-4 code inside the streamed generic engine's
    gate (N=8320)."""
    if code == "qc":
        return generate_qc_peg(8, 4, 128, 3, seed=3).to_hmatrix()
    if code == "stream":
        return generate_regular_ldpc(num_bits=8320, num_checks=4160,
                                     column_weight=4, seed=5)
    return generate_regular_ldpc(num_bits=512, num_checks=256,
                                 column_weight=3, seed=3)


def config(qber, **kw):
    base = dict(
        trials_number=23,
        simulation_seed=9,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=30,
        r_qber_ranges=(RQBERRange(0.99, qber, qber, 0.01),),
        batch_size=10,
        use_pallas=True,
        enable_throughput_measurement=True,
    )
    base.update(kw)
    return Config(**base)


def run_setup(name):
    """(matrix, combination, config) of one of ``RUNS``."""
    code, qber, fields, scaling = RUNS[name]
    matrix = matrix_of(code)
    cfg = config(qber, **fields)
    params = HMatrixParams()
    if cfg.enable_code_rate_adaptation:
        params = adapt_code_rate(np.random.default_rng(3), matrix, qber, 0.1,
                                 1.3)
        finalize_bits_to_remove(matrix, params, False)
    comb = sim.SimCombination(qber, params, sim.ScalingFactors(*scaling))
    return matrix, comb, cfg


def psum_inputs():
    rng = np.random.default_rng(0)
    syn = rng.random(PSUM_FRAMES) < 0.8
    keys = syn & (rng.random(PSUM_FRAMES) < 0.9)
    iters = rng.integers(1, 40, PSUM_FRAMES)
    return syn, keys, iters


def edge_inputs():
    """(layout, llr [B,N] float64, syndrome [B,M]) of the edge case."""
    matrix = matrix_of("medium")
    layout = layout_for(matrix)
    rng = np.random.default_rng(0)
    n = matrix.num_bit_nodes
    alice = rng.integers(0, 2, (EDGE_FRAMES, n)).astype(np.int8)
    bob = alice ^ (rng.random((EDGE_FRAMES, n)) < EDGE_QBER).astype(np.int8)
    log_p = math.log((1 - EDGE_QBER) / EDGE_QBER)
    llr = np.where(bob == 1, -log_p, log_p)
    syndrome = calculate_syndrome(layout, torch.from_numpy(alice)).numpy()
    return layout, llr, syndrome


def reduce_setup():
    """(matrix, config, ChunkArgs) of the reduce-mode case: the medium code,
    SPA, cap 40, QBER 0.02, the ``xla`` engine (per-rank seeds)."""
    matrix = matrix_of("medium")
    cfg = Config(
        trials_number=REDUCE_TRIALS,
        simulation_seed=9,
        decoding_algorithm=DecodingAlgorithm.SPA,
        decoding_alg_max_iterations=40,
        r_qber_ranges=(RQBERRange(0.99, 0.02, 0.02, 0.01),),
        use_pallas=False,
    )
    num_errors = exact_error_count(matrix.num_bit_nodes, 0.02)
    args = sim.ChunkArgs(0, num_errors,
                         log_ratio(num_errors / matrix.num_bit_nodes),
                         (1.0, 1.0, 0.0))
    return matrix, cfg, args


def result_fields(result):
    return dataclasses.asdict(result)


def per_rank_source(seed, world, local):
    """A ``key_source`` for one process that hands each chunk the draws of
    the ranks of a world of ``world``, ``local`` frames each, in rank order
    (``default_key_source`` of each rank), cut to the batch asked for."""
    sources = [sim.default_key_source(seed, "cpu", rank)
               for rank in range(world)]

    def source(sim_number, chunk_index, batch, n, **kw):
        draws = [s(sim_number, chunk_index, local, n, **kw) for s in sources]
        return tuple(torch.cat(part)[:batch] for part in zip(*draws))

    return source


def spawn(mode, init, world, out, timeout_s):
    """Run the ``world`` ranks of ``mode`` as processes; returns their
    (exit code, stderr) in rank order and the seconds they took. Every rank
    still running at ``timeout_s`` is killed and reported with code None."""
    start = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, init, str(world), str(rank),
         str(out)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
        for rank in range(world)]
    outcomes = []
    for p in procs:
        try:
            left = max(0.0, timeout_s - (time.monotonic() - start))
            _, err = p.communicate(timeout=left)
            outcomes.append((p.returncode, err))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            outcomes.append((None, err))
    return outcomes, time.monotonic() - start


def shared_cards_case(group):
    """The NCCL check of ``make_data_mesh`` on a gloo group (it reads only
    the store): two ranks naming one card must raise, two cards not."""
    outcome = []
    for index in (0, dist.get_rank(group)):
        try:
            driver._refuse_shared_cards(torch.device("cuda", index), group)
            outcome.append(False)
        except ValueError:
            outcome.append(True)
    return outcome


def run_cases(rank, out):
    results = {}
    sub = dist.new_group([0, 1])
    meshes = {4: driver.make_data_mesh("cpu")}
    if rank < 2:
        meshes[2] = driver.make_data_mesh("cpu", group=sub)
    for world in WORLDS:
        mesh = meshes.get(world)
        if mesh is None:
            continue
        assert mesh.world_size == world
        for name in RUNS:
            matrix, comb, cfg = run_setup(name)
            for reduce in (False, True):
                factory = driver.mesh_step_factory(mesh, reduce_stats=reduce)
                res = sim.run_combination(matrix, comb, cfg, SIM_NUMBER, "cpu",
                                          step_factory=factory)
                results[name, world, reduce] = result_fields(res)
        layout, llr, syndrome = edge_inputs()
        for dtype in EDGE_DTYPES:
            decode = driver.edge_sharded_decoder(
                layout, DecodingAlgorithm.NMSA, 30, mesh, dtype=dtype)
            r = decode(torch.from_numpy(llr).to(dtype),
                       torch.from_numpy(syndrome), 0.8, 1.0, 0.0)
            results["edge", world, str(dtype)] = (
                r.decision.numpy(), r.syndromes_match.numpy(),
                r.iterations.numpy())

    syn, keys, iters = psum_inputs()
    part = slice(rank * PSUM_FRAMES // 4, (rank + 1) * PSUM_FRAMES // 4)
    results["psum"] = driver.psum_stats(
        torch.from_numpy(syn[part]), torch.from_numpy(keys[part]),
        torch.from_numpy(iters[part]), meshes[4])

    if rank < 2:
        results["checkpoint"] = checkpoint_case(meshes[2], out, sub)
        results["shared_cards"] = shared_cards_case(sub)
    return results


def checkpoint_case(mesh, out, group):
    """A two-combination sweep at world 2 with a checkpoint of each rank's
    own: rank 0 alone writes. Then both ranks resume from rank 0's file,
    which holds the whole sweep, so no combination runs again."""
    matrix, comb, cfg = run_setup("generic")
    other = dataclasses.replace(comb, config_qber=0.05)
    inputs = [sim.SimInput(matrix, Path("medium.mtrx"), [comb, other])]
    factory = driver.mesh_step_factory(mesh)
    own = out / f"checkpoint{mesh.rank}.json"
    first = sim.qkd_ldpc_batch_simulation(inputs, cfg, "cpu",
                                          checkpoint_path=own,
                                          step_factory=factory)
    written = own.exists()
    dist.barrier(group=group)
    ticks = []
    again = sim.qkd_ldpc_batch_simulation(
        inputs, cfg, "cpu", progress=lambda inc, total: ticks.append(inc),
        checkpoint_path=out / "checkpoint0.json", step_factory=factory)
    return (written, [result_fields(r) for r in first],
            [result_fields(r) for r in again], ticks)


def run_reduce():
    matrix, cfg, args = reduce_setup()
    mesh = driver.make_data_mesh("cpu")
    reduced = driver.sharded_step(matrix, cfg, REDUCE_TRIALS, mesh,
                                  reduce_stats=True)
    gathered = driver.sharded_step(matrix, cfg, REDUCE_TRIALS, mesh)
    return {"world": mesh.world_size, "rank": mesh.rank,
            "stats": reduced(args, 0, REDUCE_TAKE),
            "frames": gathered(args, 0, REDUCE_TAKE)}


def _span_parent(event):
    """The innermost ``sim.*`` or ``parallel.*`` span around a profiler
    event."""
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith(("sim.",
                                                             "parallel.")):
        parent = parent.cpu_parent
    return parent


def run_spans():
    """Each traced step call: the names of the spans directly inside its
    ``parallel.step``, its ``parallel.reduce``'s microseconds and the names
    of the spans directly inside that; and the step's ``times``."""
    from torch.profiler import ProfilerActivity, profile

    matrix, comb, cfg = run_setup("generic")
    cfg = dataclasses.replace(cfg, enable_throughput_measurement=False)
    factory = driver.mesh_step_factory(driver.make_data_mesh("cpu"),
                                       reduce_stats=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run_combination(matrix, comb, cfg, SIM_NUMBER, "cpu",
                            step_factory=factory)
    events = sorted((e for e in prof.events()
                     if e.name.startswith("parallel.")),
                    key=lambda e: e.time_range.start)
    steps = []
    for e in events:
        if e.name != "parallel.step":
            continue
        inner = [c for c in events if _span_parent(c) is e]
        reduces = [c for c in inner if c.name == "parallel.reduce"]
        steps.append({
            "inner": [c.name for c in inner],
            "outer": None if _span_parent(e) is None else _span_parent(e).name,
            "reduce_us": [c.time_range.elapsed_us() for c in reduces],
            "in_reduce": [[w.name for w in events if _span_parent(w) is c]
                          for c in reduces],
        })
    return {"steps": steps, "times": list(factory(matrix, cfg,
                                                  cfg.batch_size).times)}


def run_fail(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    matrix, cfg, args = reduce_setup()
    mesh = driver.make_data_mesh("cpu")
    driver.sharded_step(matrix, cfg, REDUCE_TRIALS, mesh)(args, 0, REDUCE_TAKE)
    return {}


def main() -> int:
    mode, init, world, rank, out = sys.argv[1:6]
    world, rank, out = int(world), int(rank), Path(out)
    torch.set_num_threads(1)
    if init.startswith("file:"):
        store = dist.FileStore(init[len("file:"):], world)
        dist.init_process_group("gloo", store=store, world_size=world,
                                rank=rank,
                                timeout=timedelta(seconds=INIT_TIMEOUT_S))
    else:
        driver.initialize_distributed(init[len("tcp:"):], world, rank,
                                      backend="gloo",
                                      timeout_s=INIT_TIMEOUT_S)
    try:
        if mode == "cases":
            results = run_cases(rank, out)
        elif mode == "reduce":
            results = run_reduce()
        elif mode == "spans":
            results = run_spans()
        else:
            results = run_fail(rank)
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
