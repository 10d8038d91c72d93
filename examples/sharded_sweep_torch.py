"""One config's sweep split over the ranks of a torchrun job, one rank per
device, with the PyTorch port's distribution layer.

    torchrun --standalone --nproc-per-node N examples/sharded_sweep_torch.py \\
        CONFIG MATRIX RESULTS [--device cuda|cpu] [--backend nccl|gloo] \\
        [--reduce]

Every rank joins the group through ``initialize_distributed`` (which reads
torchrun's environment), takes its device from ``make_data_mesh`` (``cuda:
LOCAL_RANK`` by default; ``--device cpu`` for CPU ranks) and runs
``qkd_ldpc_batch_simulation`` with ``mesh_step_factory``: each chunk's
frames are split over the ranks, through the same kernels as a single-rank
run, and the statistics are gathered per frame or, with ``--reduce``,
reduced on the device. Rank 0 writes the CSV (on the engines with an mc
mode, the single-rank run's rows apart from throughput). Ranks that share
one card need ``--backend gloo``; the default is NCCL where CUDA is
available.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.distributed as dist

from qkd_ldpc_v_tpu_torch.config import parse_config_data
from qkd_ldpc_v_tpu_torch.parallel import (
    initialize_distributed,
    make_data_mesh,
    mesh_step_factory,
)
from qkd_ldpc_v_tpu_torch.simulation import (
    prepare_sim_inputs,
    qkd_ldpc_batch_simulation,
    write_file,
)
from qkd_ldpc_v_tpu_torch.utils import format_duration


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", type=Path, help="a config file (JSON)")
    parser.add_argument("matrix", type=Path, help="a matrix file")
    parser.add_argument("results", type=Path, help="directory of the CSV")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    parser.add_argument("--reduce", action="store_true",
                        help="reduce the statistics on the device")
    args = parser.parse_args(argv)

    initialize_distributed(backend=args.backend)
    try:
        mesh = make_data_mesh(args.device)
        cfg = parse_config_data(args.config)
        start = time.monotonic()
        results = qkd_ldpc_batch_simulation(
            prepare_sim_inputs([args.matrix], cfg), cfg, mesh.device,
            step_factory=mesh_step_factory(mesh, reduce_stats=args.reduce))
        if mesh.rank == 0:
            path = write_file(results, cfg,
                              format_duration(time.monotonic() - start),
                              args.results)
            print(f"{mesh.world_size} ranks: {path}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
