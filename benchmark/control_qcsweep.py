"""The control of the QC sweep's correctness check: the layered reference,
in bfloat16 (the nearest precision below the configuration's float32),
put in the program's place. A run with the control in place has to come
out not correct.

    python3 benchmark/control_qcsweep.py --workload qc10k-sweep --seed N --seconds 0 --trace 0

takes ``run.py``'s arguments and runs the cell as ``run.py`` does, with a
hook put in before set-up: each chunk step's decode is the bfloat16
layered reference of the same frames (``reference/layered.py``), their
keys drawn again by the mc rule, so the program's statistics carry the
control's answers. The window runs at least one whole pass, and the run's
own comparison then judges it. The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmark import run  # noqa: E402
from benchmark.reference import channel, layered  # noqa: E402
from benchmark.reference.qc import read_qc  # noqa: E402


def hooks(cell) -> None:
    """Put the bfloat16 layered reference in the program's place."""
    from qkd_ldpc_v_tpu_torch import simulation

    torch = cell.ctx.torch
    w, c = cell.w, cell.ctx.config
    code = read_qc(cell.ctx.path(c["matrix"]))
    layers = {}

    def decode(step, args, chunk_index):
        dev = step.device
        if str(dev) not in layers:
            layers[str(dev)] = layered.Layers(code, dev)
        out = layered.chunk_outcome(
            layers[str(dev)],
            channel.chunk_seed(cell.seed, args.sim_number, chunk_index),
            step.frame0, step.frames, args.num_errors, w["algorithm"],
            w["primary"], w["secondary"], c["max_iterations"],
            dtype=torch.bfloat16)
        return tuple(torch.as_tensor(x, device=dev) for x in out)

    simulation.ChunkStep.decode = decode


def main(argv=None) -> int:
    return run.main(argv, hooks=hooks, script=__file__)


if __name__ == "__main__":
    sys.exit(main())
