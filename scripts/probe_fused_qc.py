#!/usr/bin/env python3
"""Split the fused QC kernel's main-path chunk on one card.

    python3 scripts/probe_fused_qc.py

On the headline QC code (N=10240, Z=512), 16384 frames of chunk 0 of
simulation seed 42 at QBER 0.03, NMSA alpha 0.65, it times (after one
untimed launch, the mean of three launches):

  * the mc chunk at iteration caps 0, 1 and 2 and at the main path's cap of
    100, layered and flooding: cap 0 is the staging alone (the draw, the
    selection, the syndrome and the key compare), and from cap 1 to cap 2
    every frame makes one more sweep (none converges within two at this
    QBER), so their difference is one sweep of every frame;
  * the SPA mc chunk (flooding) with the SPA pair's messages in shared
    memory (one block per SM) and forced into the per-block global slice
    (more blocks per SM), in turns (shared, global, global, shared), whose
    outputs must agree.

It prints the card's name and power limit and one line per measurement. It
needs one CUDA device.
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
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.ops import fused_qc, launch
    from qkd_ldpc_v_tpu_torch.ops.channel import exact_error_count, log_ratio
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    code = read_qc_matrix(ROOT / "sparse_matrices" / "matrices_qc"
                          / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
    n = code.num_bit_nodes
    ne = exact_error_count(n, 0.03)
    frames = 16384
    seed = chunk_seed(42, 0, 0)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / 3

    for schedule in ("layered", "flooding"):
        times = {}
        for cap in (0, 1, 2, 100):
            mc = fused_qc.make_fused_qc_montecarlo(
                code, DecodingAlgorithm.NMSA, cap, False, schedule)
            out, times[cap] = timed(lambda: mc(seed, 0, frames, ne,
                                               log_ratio(ne / n), 0.65, 1.0,
                                               0.0, device=dev))
            iters = int(out[2].sum().item())
            print(f"{schedule} mc cap {cap}: {times[cap]:.3f} ms, mean "
                  f"iterations {iters / frames:.2f} ({card})", flush=True)
        print(f"{schedule}: staging {times[0]:.3f} ms, one sweep of every "
              f"frame {times[2] - times[1]:.3f} ms ({card})", flush=True)

    def global_plan(qc, flags, device):
        return fused_qc._Launch(qc, flags, device, messages="global")

    makers = {
        "shared": fused_qc.make_fused_qc_montecarlo(
            code, DecodingAlgorithm.SPA, 100, False, "flooding"),
        "global": launch.qc_montecarlo(
            "fused QC", fused_qc.COUNTS, launch.cached_plans(global_plan),
            code, DecodingAlgorithm.SPA, 100, False, "flooding"),
    }
    turns = {"shared": [], "global": []}
    seen = None
    for which in ("shared", "global", "global", "shared"):
        mc = makers[which]
        out, ms = timed(lambda: mc(seed, 0, frames, ne, log_ratio(ne / n),
                                   1.0, 1.0, 0.0, device=dev))
        stats = tuple(int(t.to(torch.int64).sum().item()) for t in out)
        if seen is None:
            seen = stats
        if stats != seen:
            print(f"SPA mc: {which} outputs differ", file=sys.stderr)
            return 1
        turns[which].append(ms)
        print(f"SPA mc, messages {which}: {ms:.3f} ms", flush=True)
    for which, t in turns.items():
        print(f"SPA mc, messages {which}: mean {sum(t) / len(t):.3f} ms "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
