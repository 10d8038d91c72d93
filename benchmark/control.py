"""The control of a cell's correctness check: the reference put in the
program's place, computed in the nearest precision below the one the
configuration states (bfloat16 for its float32). A run of a cell with the
control in place has to come out not correct.

    python3 benchmark/control.py --workload NAME --seed N --seconds 0 --trace 0

takes ``run.py``'s arguments and runs the cell as ``run.py`` does, every
rank included, with ``hooks`` put in before set-up:
  * a sweep: each chunk step's decode is the bfloat16 reference of the
    same frames, their keys drawn again by the cell's rule, so the
    program's statistics and, across cards, its reduction carry the
    control's answers;
  * a rounds cell: each round is the bfloat16 reference's round (frames,
    LLRs, decode, bit removal).
The window runs at least one whole pass (a sweep) or round, and the run's
own comparison then judges it. The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmark import run  # noqa: E402
from benchmark.reference import channel, compare  # noqa: E402
from benchmark.reference.alist import read_alist  # noqa: E402
from benchmark.reference.decoder import Graph  # noqa: E402


def hooks(cell) -> None:
    """Put the bfloat16 reference in the program's place in ``cell``."""
    (_rounds if cell.kind == "rounds" else _sweep)(cell)


def _sweep(cell) -> None:
    from qkd_ldpc_v_tpu_torch import simulation

    torch = cell.ctx.torch
    w, c = cell.w, cell.ctx.config
    graphs = {}

    def decode(step, args, chunk_index):
        dev = step.device
        if str(dev) not in graphs:
            graphs[str(dev)] = Graph(read_alist(cell.ctx.path(c["matrix"])), dev)
        out = compare.chunk_outcome(
            graphs[str(dev)], w["keys"],
            channel.chunk_seed(cell.seed, args.sim_number, chunk_index),
            step.frame0, step.frames, step.frames, args.num_errors,
            w["algorithm"], w["primary"], w["secondary"], c["max_iterations"],
            dtype=torch.bfloat16)
        return tuple(torch.as_tensor(x, device=dev) for x in out)

    # Every chunk step of the process, the sharded one's inner step too.
    simulation.ChunkStep.decode = decode


def _rounds(cell) -> None:
    from benchmark.drivers import rounds

    torch = cell.ctx.torch
    w, c = cell.w, cell.ctx.config
    code = read_alist(cell.ctx.path(c["matrix"]))
    graph = Graph(code, cell.ctx.device)
    points = rounds.reference_points(code, cell.ctx.path(c["untainted"]), w)
    algorithm, primary, secondary, qber = rounds.decoding(1.0 - code.m / code.n, w)

    def round_(s, block):
        point = points[s]
        inputs = rounds.round_inputs(cell.pool, block,
                                     len(point.payload(code.n)),
                                     len(point.punctured))
        outcome, alice_kept, bob_kept = compare.round_reference(
            graph, point, *inputs, qber, algorithm, primary, secondary,
            c["max_iterations"], dtype=torch.bfloat16)
        res = SimpleNamespace(
            syndromes_match=torch.as_tensor(outcome.converged),
            keys_match=torch.as_tensor(outcome.keys),
            iterations=torch.as_tensor(outcome.iterations),
            alice_out=alice_kept, bob_out=bob_kept)
        return res, (res.syndromes_match, res.keys_match, res.iterations)

    cell._round = round_


def main(argv=None) -> int:
    return run.main(argv, hooks=hooks, script=__file__)


if __name__ == "__main__":
    sys.exit(main())
