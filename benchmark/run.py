"""Run one cell of the benchmark of ``qkd_ldpc_v_tpu_torch`` on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (``setup_s``: importing torch, the CUDA context, the kernel
library, the code, the cell's warm-up), then a window of ``S`` seconds of
the cell's traffic, untraced; with ``--trace 1`` a traced sub-window after
it. Then the program's state is freed and the reference decodes again
what the window sampled. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit. The checks are also the last lines of standard
error.

Everything is found by name: the cell ``workloads/NAME.json``, its
configuration ``configs/<config>.json``, its driver
``drivers/<driver>.py`` and the per-layer readers ``metrics/<metric>.py``
that ``BENCHMARK.json`` lists for the cell.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# One process per card with few threads: CPU thread pools that spin
# beside the card's host loop make a run's host time swing.
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import card, guard  # noqa: E402

# Seconds rank 0 waits in all, after its own run, for the other ranks to
# exit.
RANK_WAIT_S = 120


class Context:
    """What a driver gets: the cell, its configuration, the seed, the
    device, torch and, in a cell on several cards, this process's rank,
    the world size and the rendezvous address."""

    def __init__(self, torch, workload: dict, config: dict, seed: int,
                 device: str, rank: int = 0, world: int = 1,
                 address: Optional[str] = None) -> None:
        self.torch = torch
        self.workload = workload
        self.config = config
        self.seed = seed
        self.device = device
        self.rank = rank
        self.world = world
        self.address = address

    @staticmethod
    def path(name: str) -> Path:
        return HERE / "configs" / name

    def synchronize(self) -> None:
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()

    def empty_cache(self) -> None:
        if self.device.startswith("cuda"):
            self.torch.cuda.empty_cache()


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(name: str, section: str) -> List[str]:
    """The metrics of ``section`` that BENCHMARK.json gives this cell."""
    out = []
    for m in manifest()[section]:
        if name in m.get("workloads", [name]):
            out.append(m["name"])
    return out


def read_layer(metric: str, layer: dict) -> Optional[float]:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(layer)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             hooks=None, workload_overrides=None,
             config_overrides=None, rank: int = 0, world: int = 1,
             address: Optional[str] = None) -> Dict:
    """One run of the cell (of this rank, in a cell on several cards);
    returns the result line's object. ``hooks(cell)`` may replace parts
    of the program before set-up (the tests' faults, the control); the
    overrides shrink the cell for the CPU."""
    import torch

    workload = {**load_json("workloads", name), **(workload_overrides or {})}
    config = {**load_json("configs", workload["config"]),
              **(config_overrides or {})}
    ctx = Context(torch, workload, config, seed, device, rank, world, address)
    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    cell = driver.Cell(ctx)
    if hooks is not None:
        hooks(cell)
    cell.setup()
    ctx.synchronize()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    end_to_end = cell.run_window(seconds)
    end_to_end["setup_s"] = setup_s
    timing = {"setup_s": setup_s, "window_s": time.perf_counter() - t0}
    if trace:
        t0 = time.perf_counter()
        cell.run_traced()
        timing["traced_s"] = time.perf_counter() - t0
    dev = card.device(torch, workload["chips"]) if device.startswith("cuda") \
        else {"platform": "cpu", "kind": "cpu", "count": world,
              "memory_peak_bytes": 0}
    if hasattr(cell, "fullest"):
        dev["memory_peak_bytes"] = cell.fullest(dev["memory_peak_bytes"])
    if trace:
        layer = cell.layer()
        units = {m["name"]: m["unit"] for m in manifest()["per_layer"]}
        metrics = {}
        for metric in cell_metrics(name, "per_layer"):
            value = read_layer(metric, layer)
            if value is not None:
                metrics[metric] = {"value": value, "unit": units[metric]}
        t = cell.trace
        dev["busy_s"] = t.busy_s()
        dev["window_s"] = t.window_s
        breakdown = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in manifest()["end_to_end"]}
        metrics = {metric: {"value": end_to_end[metric], "unit": units[metric]}
                   for metric in cell_metrics(name, "end_to_end")}
    cell.release()
    gc.collect()

    t0 = time.perf_counter()
    numbers = cell.compare()
    timing["reference_s"] = time.perf_counter() - t0
    if hasattr(cell, "close"):
        cell.close()
    limits = workload["compare"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": cell.attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown
    out["timing"] = timing
    if device.startswith("cuda"):
        out["card"] = card.power_line()
    out["checks"] = checks
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _start_ranks(args, world: int, address: str, script: str) -> list:
    """Ranks 1 .. world - 1 of this run, as processes of ``script``."""
    return [subprocess.Popen(
        [sys.executable, script,
         "--workload", args.workload, "--seed", str(args.seed),
         "--seconds", str(args.seconds), "--trace", str(args.trace),
         "--rank", str(rank), "--address", address],
        stdout=subprocess.DEVNULL) for rank in range(1, world)]


def _stop_ranks(procs) -> bool:
    """Wait for every rank, ``RANK_WAIT_S`` in all, and end any still
    running then. True when every rank exited with 0."""
    ok = True
    deadline = time.monotonic() + RANK_WAIT_S
    for p in procs:
        try:
            ok &= p.wait(timeout=max(0.0, deadline - time.monotonic())) == 0
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            ok = False
    return ok


def _loaded_forbidden() -> bool:
    """Whether this process loaded JAX or the JAX package; names on
    standard error what it found."""
    found = guard.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
    return bool(found)


def main(argv=None, hooks=None, script=None) -> int:
    """The command line. ``hooks`` and ``script`` are the control's
    (``control.py``): the hook goes to every rank's ``run_cell``, and the
    other ranks run ``script`` (this file by default)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank of a cell on several cards, started by rank 0.
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    workload = load_json("workloads", args.workload)
    world = workload["chips"]
    try:
        card.require(torch, world)
    except card.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    run = dict(rank=args.rank, world=world, address=args.address, hooks=hooks)
    if args.rank:
        run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 **run)
        # Rank 0 sees this rank's exit code: a rank that loaded JAX
        # leaves the run without a result.
        return 3 if _loaded_forbidden() else 0
    procs = []
    if world > 1:
        run["address"] = f"localhost:{_free_port()}"
        procs = _start_ranks(args, world, run["address"],
                             str(Path(script or __file__).resolve()))
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), **run)
    except BaseException:
        for p in procs:
            p.kill()
        _stop_ranks(procs)
        raise
    if not _stop_ranks(procs):
        print("benchmark: a rank failed; no result", file=sys.stderr)
        return 4
    if _loaded_forbidden():
        return 3
    print("timing " + " ".join(f"{k}={v:.3f}" for k, v in out["timing"].items()),
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
