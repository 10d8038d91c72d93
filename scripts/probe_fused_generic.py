#!/usr/bin/env python3
"""Split the fused generic kernel's main-path chunk on one card.

    python3 scripts/probe_fused_generic.py

On the 10k alist code (N=10240, M=2841, check degrees 14-15), 16384 mc
frames of chunk 0 of simulation seed 42 at QBER 0.025, NMSA alpha 0.70
(cell 4), it times (after one untimed launch, the mean of three launches):

  * the mc chunk at iteration caps 0, 1 and 2 and at the main path's cap of
    100: cap 0 is the staging alone (the draw, the selection, the syndrome
    and the key compare), and from cap 1 to cap 2 every frame makes one
    more sweep (none converges within two at this QBER), so their
    difference is one sweep of every frame;
  * the mc chunk (cap 100) at 256, 512 and 1024 threads per block, in
    turns (256, 512, 1024, 1024, 512, 256), NMSA and SPA-lin;
  * the mc chunk (cap 100) with the checks in shared memory and forced into
    the per-block global slice, in turns (shared, global, global, shared),
    NMSA and SPA-lin.

Outputs must agree across every variant of a case. It prints the card's
name and power limit, each plan's shared bytes and blocks per SM, and one
line per measurement. It needs one CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.ops import fused_generic as fg
    from qkd_ldpc_v_tpu_torch.ops import launch
    from qkd_ldpc_v_tpu_torch.ops.channel import exact_error_count, log_ratio
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    code = read_sparse_matrix_alist(
        ROOT / "sparse_matrices" / "matrices_alist"
        / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
    n = code.num_bit_nodes
    ne = exact_error_count(n, 0.025)
    frames = 16384
    seed = chunk_seed(42, 0, 0)
    nmsa, spa_lin = DecodingAlgorithm.NMSA, DecodingAlgorithm.SPA_APPROX

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / 3

    def run(mc, alpha):
        return timed(lambda: mc(seed, 0, frames, ne, log_ratio(ne / n), alpha,
                                1.0, 0.0, device=dev))

    times = {}
    for cap in (0, 1, 2, 100):
        mc = fg.make_fused_generic_montecarlo(code, nmsa, cap, False)
        out, times[cap] = run(mc, 0.7)
        iters = int(out[2].sum().item())
        print(f"NMSA mc cap {cap}: {times[cap]:.3f} ms, mean iterations "
              f"{iters / frames:.2f} ({card})", flush=True)
    print(f"NMSA mc: staging {times[0]:.3f} ms, one sweep of every frame "
          f"{times[2] - times[1]:.3f} ms ({card})", flush=True)

    def variant(alg, **plan):
        def make(matrix, flags, device):
            built = fg._Launch(matrix, flags, device, **plan)
            print(f"{alg.name} {plan}: mc plan {built.plans['mc']}, "
                  f"{built.per_sm['mc']} blocks per SM", flush=True)
            return built

        return launch.generic_montecarlo("fused generic", fg.COUNTS,
                                         launch.cached_plans(make), code, alg,
                                         100, False)

    cases = [(alg, "threads", [{"threads": t} for t in (256, 512, 1024)])
             for alg in (nmsa, spa_lin)]
    cases += [(alg, "checks", [{"checks": c} for c in ("shared", "global")])
              for alg in (nmsa, spa_lin)]
    for alg, what, plans in cases:
        makers = [variant(alg, **plan) for plan in plans]
        order = list(range(len(plans))) + list(reversed(range(len(plans))))
        turns = {i: [] for i in order}
        seen = None
        for i in order:
            out, ms = run(makers[i], 0.7 if alg is nmsa else 1.0)
            stats = tuple(int(t.to(torch.int64).sum().item()) for t in out)
            if seen is None:
                seen = stats
            if stats != seen:
                print(f"{alg.name} {plans[i]}: outputs differ", file=sys.stderr)
                return 1
            turns[i].append(ms)
            print(f"{alg.name} mc {plans[i]}: {ms:.3f} ms", flush=True)
        for i, t in turns.items():
            print(f"{alg.name} mc {plans[i]}: mean {sum(t) / len(t):.3f} ms "
                  f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
