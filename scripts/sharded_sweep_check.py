#!/usr/bin/env python3
"""A sweep over ranks against one rank, on the cards of one machine.

    python3 scripts/sharded_sweep_check.py [--ranks N] [--backend nccl|gloo]
        [--trials T] [--batch B] [--device cuda|cpu]

Cell 1's config (a copy of configs/example_qc_layered.json, layered, over
the committed headline QC asset; by default 65536 trials in chunks of
16384) runs once through the CLI on one card, which also builds the
kernels, then under ``torchrun --standalone --nproc-per-node N`` through
examples/sharded_sweep_torch.py, one rank per card (``cuda:LOCAL_RANK``;
NCCL by default), gathered and then reduced. Each sharded CSV must equal
the single-rank CSV in every column but throughput (the ranks split each
chunk by frame offset of its Philox stream, so they decode the same
frames). It prints the card's name and power limit, the number of cards,
and the chunk-timer frames/s of each run. ``--device cpu`` (with
``--backend gloo``) runs the same on CPU ranks, the kernels' plain
versions, as a rehearsal. Work files go under build/sharded_sweep_check/.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from qkd_ldpc_v_tpu_torch.config import parse_config_data  # noqa: E402

HEADLINE = (ROOT / "sparse_matrices" / "matrices_qc"
            / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
HEADLINE_N = 10240


def run(cmd):
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def rows(directory: Path):
    """(rows without the throughput columns, THROUGHPUT_MEAN of each row)."""
    (path,) = directory.glob("*.csv")
    header, *lines = path.read_text().splitlines()
    names = header.split(";")
    table = [dict(zip(names, line.split(";"))) for line in lines]
    return ([{k: v for k, v in r.items() if not k.startswith("THROUGHPUT")}
             for r in table], [float(r["THROUGHPUT_MEAN"]) for r in table])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--trials", type=int, default=65536)
    parser.add_argument("--batch", type=int, default=16384)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).strip().splitlines()[0]
        card += f"; {torch.cuda.device_count()} cards"
    else:
        card = "CPU ranks"
    print(f"{card}; {args.ranks} ranks ({args.backend})", flush=True)

    work = ROOT / "build" / "sharded_sweep_check"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / HEADLINE.name).symlink_to(HEADLINE)
    cfg = json.loads((ROOT / "configs" / "example_qc_layered.json").read_text())
    cfg["trials_number"] = args.trials
    cfg["tpu"]["batch_size"] = args.batch
    cfg["tpu"]["schedule"] = "layered"
    (work / "configs").mkdir()
    config = work / "configs" / "run.json"
    config.write_text(json.dumps(cfg, indent=2))
    parsed = parse_config_data(config)
    rtt_us = parsed.rtt_ms * 1e3 if parsed.consider_rtt else 0.0

    def frames_per_s(throughput):
        return 1e6 / (HEADLINE_N * 1e6 / throughput - rtt_us)

    run([sys.executable, "-m", "qkd_ldpc_v_tpu_torch", "--configs",
         str(work / "configs"), "--matrices", str(work / "sparse_matrices"),
         "--results", str(work / "single"), "--device", args.device,
         "--quiet"])
    want, single_tp = rows(work / "single")
    print(f"1 rank: {frames_per_s(single_tp[0]):.0f} frames/s (chunk "
          f"timers, RTT removed)", flush=True)
    ok = True
    for mode in ("gathered", "reduced"):
        out = work / mode
        run([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={args.ranks}",
             str(ROOT / "examples" / "sharded_sweep_torch.py"), str(config),
             str(matrices / HEADLINE.name), str(out), "--backend",
             args.backend, "--device", args.device]
            + (["--reduce"] if mode == "reduced" else []))
        got, tp = rows(out)
        same = got == want
        ok &= same
        print(f"{args.ranks} ranks, {mode}: {frames_per_s(tp[0]):.0f} "
              f"frames/s, {frames_per_s(tp[0]) / frames_per_s(single_tp[0]):.2f}"
              f"x one rank; rows {'equal' if same else 'DIFFER from'} the "
              f"single rank's apart from throughput", flush=True)
        if not same:
            print(f"  {got}\n  {want}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
