#!/usr/bin/env python3
"""Time compiled variants of the fused generic kernel on one card, to split
its time.

    python3 scripts/variants_fused_generic.py [VARIANT ...]

Each variant is this checkout's package copied to
``build/variants/<name>`` with textual edits to ``csrc/fused_generic.cu``
(and, where the layout changes, to ``ops/fused_generic.py``), built there
at first use and timed in its own process, in turns with the unchanged
kernel (base, variant, variant, base): the 10k alist code, 16384 frames of
chunk 0 of simulation seed 42 at QBER 0.025, NMSA alpha 0.70, the mc mode
(cell 4), at iteration cap 0 (the staging alone), cap 2 (two sweeps of
every frame more: none converges within two at this QBER) and the main
path's cap of 100; after one untimed launch, the mean of three. A variant
that breaks exactness changes how frames converge, so its cap-100 time is
not comparable; its cap-0 and cap-2 times are.

Variants (default: all):
  * tables16: the checks' bit table and the bits' (check, slot) words as
    16-bit entries (check < 4096 and slot < 16, and an even edge count: the
    10k alist code's M = 2841, degrees <= 15 and E = 40960 fit), halving
    the tables' bytes; it stays exact, so its outputs must equal the
    base's;
  * one_block_per_sm: 100000 more bytes of shared memory per block, so
    that one block fits an SM where two did;
  * run16: every check of at most 16 edges in the 16-slot register run.

It prints the card's name and power limit, one line per turn and each
variant's means beside the base's. It needs one CUDA device.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("qkd_ldpc_v_tpu_torch") / "csrc" / "fused_generic.cu"
WRAPPER = Path("qkd_ldpc_v_tpu_torch") / "ops" / "fused_generic.py"
CELLS = ("0", "2", "100")

# name: [(file, text in it, its replacement), ...]
VARIANTS = {
    "tables16": [
        (WRAPPER,
         "        cbit,\n"
         "        np.zeros(RUN, dtype=np.int64),\n"
         "        bent,\n",
         "        np.concatenate([cbit, np.zeros(RUN, dtype=np.int64)])\n"
         "        .astype(np.uint16).view(np.int32),\n"
         "        (bent & 0xfff | (bent >> 16) << 12).astype(np.uint16)\n"
         "        .view(np.int32),\n"),
        (KERNEL,
         "  const int* cbit;      // [E + kRun]",
         "  const uint16_t* cbit;  // [E + kRun]"),
        (KERNEL,
         "  const int* bent;      // [E]",
         "  const uint16_t* bent;  // [E]"),
        (KERNEL,
         "  fr.cbit = reinterpret_cast<const int*>(fr.binfo + p.n);\n"
         "  fr.bent = fr.cbit + p.e + kRun;\n"
         "  fr.bit_ext = fr.bent + p.e;\n",
         "  fr.cbit = reinterpret_cast<const uint16_t*>(fr.binfo + p.n);\n"
         "  fr.bent = fr.cbit + p.e + kRun;\n"
         "  fr.bit_ext = reinterpret_cast<const int*>(fr.bent + p.e);\n"),
        (KERNEL,
         "  const int c = ent & 0xffff, slot = (int)((unsigned)ent >> 16);",
         "  const int c = ent & 0xfff, slot = ent >> 12;"),
    ],
    "one_block_per_sm": [
        (KERNEL,
         "  const size_t smem = shared_bytes(p.n, p.m, p.max_deg, flags, "
         "p.mode);\n  int err = configure(kernel, smem);",
         "  const size_t smem = shared_bytes(p.n, p.m, p.max_deg, flags, "
         "p.mode) + 100000;\n  int err = configure(kernel, smem);"),
    ],
    "run16": [
        (KERNEL,
         "  if (deg <= 6) return f(Run<6>{});\n"
         "  if (deg <= 8) return f(Run<8>{});\n"
         "  if (deg <= 10) return f(Run<10>{});\n"
         "  if (deg <= 12) return f(Run<12>{});\n"
         "  if (deg <= 14) return f(Run<14>{});\n", ""),
    ],
}


def worker(checkout: Path) -> None:
    sys.path.insert(0, str(checkout))
    import torch

    import qkd_ldpc_v_tpu_torch
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.ops import fused_generic
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        chunk_seed, exact_error_count, log_ratio)

    assert Path(qkd_ldpc_v_tpu_torch.__file__).resolve().is_relative_to(
        checkout.resolve()), qkd_ldpc_v_tpu_torch.__file__
    code = read_sparse_matrix_alist(
        ROOT / "sparse_matrices" / "matrices_alist"
        / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
    n = code.num_bit_nodes
    ne = exact_error_count(n, 0.025)
    dev = torch.device("cuda")
    out = {}
    for cap in CELLS:
        mc = fused_generic.make_fused_generic_montecarlo(
            code, DecodingAlgorithm.NMSA, int(cap), False)

        def run():
            return mc(chunk_seed(42, 0, 0), 0, 16384, ne, log_ratio(ne / n),
                      0.7, 1.0, 0.0, device=dev)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            res = run()
        torch.cuda.synchronize()
        out[cap] = {"ms": (time.perf_counter() - t0) * 1e3 / 3,
                    "stats": [int(t.to(torch.int64).sum().item())
                              for t in res]}
    print(json.dumps(out), flush=True)


def variant_tree(name: str) -> Path:
    """build/variants/<name>: the package with the variant's edits."""
    tree = ROOT / "build" / "variants" / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "qkd_ldpc_v_tpu_torch",
                    tree / "qkd_ldpc_v_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, old, new in VARIANTS[name]:
        src = tree / path
        text = src.read_text()
        if old not in text:
            raise SystemExit(f"{name}: an edit no longer applies to {path}")
        src.write_text(text.replace(old, new))
    return tree


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]))
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    if not set(names) <= set(VARIANTS):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in names:
        trees = {"base": ROOT, name: variant_tree(name)}
        times = {which: {c: [] for c in CELLS} for which in trees}
        stats = {}
        for which in ("base", name, name, "base"):
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", str(trees[which])],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for cell in CELLS:
                times[which][cell].append(res[cell]["ms"])
            stats.setdefault(which, res["100"]["stats"])
            print(f"{which}: " + ", ".join(
                f"cap {c} {res[c]['ms']:.3f} ms" for c in CELLS), flush=True)
        same = stats["base"] == stats[name]
        for cell in CELLS:
            base = sum(times["base"][cell]) / 2
            var = sum(times[name][cell]) / 2
            print(f"{name} cap {cell}: base {base:.3f} ms, variant {var:.3f} "
                  f"ms, variant/base {var / base:.4f}; cap-100 outputs "
                  f"{'equal' if same else 'differ'} ({card})", flush=True)
        if name == "tables16" and not same:
            print("tables16 is exact: its outputs must equal the base's",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
