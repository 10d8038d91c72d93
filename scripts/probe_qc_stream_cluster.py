#!/usr/bin/env python3
"""Where the streamed QC kernel's time goes, on one card.

    python3 scripts/probe_qc_stream_cluster.py [FRAMES]

For the N=102400 flagship (QBER 0.03, NMSA alpha 0.8, trial mode, the keys
of ``default_key_source`` seed 42) and the headline code forced through
the streamed kernel, it prints each mode's launch plan (CTAs per cluster,
threads, shared bytes, resident clusters) and the time of one launch of
FRAMES frames (default 4096; mean of three after one untimed) at iteration
caps 0 (set-up and the final checks), 1, 2 and 4, in both schedules, with
the plan's own cluster size and forced to twice and four times it. The
slope over the caps is the time of one iteration of every frame; cap 0 is
the staging. It needs one CUDA device and prints the card's name and
power limit first.
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
    from qkd_ldpc_v_tpu_torch.ops import launch, qc_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    qc_dir = ROOT / "sparse_matrices" / "matrices_qc"
    codes = {
        "flagship": qc_dir / "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx",
        "headline": qc_dir / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx",
    }
    for name, path in codes.items():
        code = read_qc_matrix(path)
        n = code.num_bit_nodes
        ne = exact_error_count(n, 0.03)
        alice, bits = default_key_source(42, dev)(0, 0, frames, n)
        bob = inject_errors(bits, alice, ne, wide=True)
        del bits
        lp = log_ratio(ne / n)
        base = qc_stream.plan_for(code, "trial").cluster
        for schedule in ("layered", "flooding"):
            for cluster in (base, 2 * base, 4 * base):
                plans = launch.cached_plans(
                    lambda c, f, d, k=cluster: qc_stream._Launch(c, f, d, k))
                flags = launch.kernel_flags(DecodingAlgorithm.NMSA,
                                            schedule == "layered")
                built = plans(code, flags, dev)
                plan = built.plans["trial"]
                times = []
                for cap in (0, 1, 2, 4):
                    trial = launch.qc_trial(
                        "streamed QC", qc_stream.COUNTS, plans, code,
                        DecodingAlgorithm.NMSA, cap, False, schedule)
                    args = (alice, bob, lp, 0.8, 1.0, 0.0)
                    trial(*args)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        trial(*args)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3 / 3)
                print(f"{name} {schedule} C={plan.cluster} T={plan.threads} "
                      f"smem={plan.shared_bytes} "
                      f"clusters={built.resident['trial']}: "
                      + " ".join(f"cap{c}={t:.3f}ms" for c, t in
                                 zip((0, 1, 2, 4), times))
                      + f" per-iteration={(times[3] - times[1]) / 3:.3f}ms "
                      f"({card})", flush=True)
        del alice, bob
    return 0


if __name__ == "__main__":
    sys.exit(main())
