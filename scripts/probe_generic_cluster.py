#!/usr/bin/env python3
"""The streamed generic trial's two kernels side by side, on one card.

    python3 scripts/probe_generic_cluster.py [FRAMES] [--against DIR]

For the N=102400 alist code (NMSA alpha 0.8; Alice's and Bob's keys from
``default_key_source`` with exact error counts) it prints the cluster
kernel's plan (frames a cluster decodes at once, CTAs per cluster, threads
and shared bytes per CTA, clusters in flight, the L2 working set) and the
compiler's report of its registers and spills, holds the plan to the
library's layout, holds the cluster kernel at each group size (1, 2, 4, 8
frames a cluster) to the plain version and to the batch-minor kernel on
128 frames of each min-sum algorithm at QBER 0.038 (the waterfall), then,
at each of the benchmark's points (QBER 0.020-0.035), times FRAMES frames
(default 4096) through the batch-minor kernel (its own group size) and the
cluster kernel at each group size in turns, beside the chunk's bound, and
the plan's cluster kernel at iteration caps 0, 1 and 2 (the staging and the
key compare; one iteration of every frame). With ``--against DIR`` it
also builds DIR's ``qkd_ldpc_v_tpu_torch/csrc/generic_cluster.cu`` alone
(another checkout, e.g. the parent commit unpacked with ``git archive``;
its C entry ``generic_cluster_trial`` must take this one's arguments),
prints its compiler report, and at each point times the plan's cluster
kernel of both builds in turns (DIR, this, this, DIR), their outputs held
equal. It needs one CUDA device and prints the card's name and power limit
first; it exits 1 where a comparison differs.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ALIST100K = (ROOT / "sparse_matrices" / "matrices_alist"
             / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx")
FACTORS = {"NMSA": (0.8, 1.0), "OMSA": (0.3, 1.0), "ANMSA": (0.88, 0.5),
           "AOMSA": (0.3, 0.6)}
POINTS = (0.02, 0.025, 0.03, 0.035)
CAP = 100


def timed(torch, fn, reps=1):
    """(result of the last call, mean ms per call) between synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def same(got, want) -> bool:
    return all(bool((g.cpu() == w.cpu()).all()) for g, w in zip(got, want))


def cluster_report(log: str) -> None:
    for line in log.splitlines():
        if "generic_stream_kernel_cluster" in line or "spill" in line:
            print("ptxas:", line.strip())


def build_against(tree: Path):
    """DIR's cluster kernel alone, built with the library's flags into a
    shared library under build/, with its trial entry declared as this
    tree's; prints the compiler's report."""
    from qkd_ldpc_v_tpu_torch import kernels

    src = tree / "qkd_ldpc_v_tpu_torch" / "csrc" / "generic_cluster.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "probe_against" / f"generic_cluster-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                           "-v", "-shared", "-o", str(out), str(src)],
                          capture_output=True, text=True, check=True)
    print(f"against {tree}:", flush=True)
    cluster_report(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    args, res = kernels.SIGNATURES["generic_cluster_trial"]
    lib.generic_cluster_trial.argtypes = args
    lib.generic_cluster_trial.restype = res
    return lib


def main() -> int:
    import torch

    from benchmark.harness.bounds import bound
    from qkd_ldpc_v_tpu_torch import kernels
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    against = None
    if "--against" in argv:
        at = argv.index("--against")
        against = Path(argv[at + 1]).resolve()
        del argv[at:at + 2]
    frames = int(argv[0]) if argv else 4096
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    kernels.library()
    print(f"kernels built in {kernels.build_seconds:.1f} s", flush=True)
    cluster_report(kernels.build_log)
    matrix = read_sparse_matrix_alist(ALIST100K)
    other = build_against(against) if against else None
    n, e = matrix.num_bit_nodes, matrix.num_edges
    lib = kernels.library()
    ok = True
    for nn, mm in ((288, 144), (10240, 2841), (22000, 11000), (102400, 31744)):
        for f in generic_stream.CLUSTER_FRAMES:
            for c in generic_stream.CLUSTER_SIZES:
                py = (min(generic_stream.THREADS,
                          f * max(generic_stream._share(nn, c),
                                  generic_stream._share(mm, c))),
                      generic_stream.cluster_shared_bytes(nn, mm, f, c))
                got = (lib.generic_cluster_threads(nn, mm, f, c),
                       lib.generic_cluster_shared_bytes(nn, mm, f, c))
                ok &= py == got
            ok &= lib.generic_cluster_record_bytes(mm, f) \
                == -(-16 * mm * f // 256) * 256
    ok &= (lib.generic_cluster_max_groups(), lib.generic_cluster_max_degree(),
           lib.generic_cluster_max_frames()) \
        == (generic_stream.MAX_GROUPS, generic_stream.MAX_DEGREE,
            max(generic_stream.CLUSTER_FRAMES))
    print(f"layout equals the library's: {ok}", flush=True)

    def keys(qber, count, seed=42):
        ne = exact_error_count(n, qber)
        alice, bits = default_key_source(seed, dev)(0, 0, count, n)
        return alice, inject_errors(bits, alice, ne, wide=True), \
            log_ratio(ne / n)

    def launcher(algorithm, frames, lib=None):
        """The cluster kernel at ``frames`` frames a cluster (the plan's
        where None), as a trial; ``lib``: another build's entry."""
        flags = fused_generic.generic_flags(algorithm)
        plan = generic_stream._Launch(matrix, flags, dev, None, frames)

        def run(alice, bob, lp, f1, f2, thr):
            outs = tuple(torch.empty(alice.shape[0], dtype=t, device=dev)
                         for t in (torch.int8, torch.int8, torch.int32))
            batch = alice.shape[0]
            inputs = (alice.data_ptr(), bob.data_ptr(), batch)
            scalars = (flags, 0, CAP, lp, f1, f2, thr)
            if lib is None:
                err = plan.launch("trial", batch, inputs, scalars, outs)
            else:
                cp = plan.cluster
                clusters = min(-(-batch // cp.frames), plan.clusters)
                scratch = torch.empty(256 + clusters * cp.record_bytes,
                                      dtype=torch.uint8, device=dev)
                err = lib.generic_cluster_trial(
                    *inputs, *plan.cluster_shape, *scalars,
                    scratch.data_ptr(), cp.frames, cp.cluster, clusters,
                    *(o.data_ptr() for o in outs),
                    torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return outs[0].bool(), outs[1].bool(), outs[2]
        return plan, run

    alice, bob, lp = keys(0.038, 128)
    for alg, (f1, f2) in FACTORS.items():
        algorithm = DecodingAlgorithm[alg]
        trial = generic_stream.make_generic_stream_trial(matrix, algorithm,
                                                         CAP, False)
        generic_stream.reset_counts()
        got = trial(alice, bob, lp, f1, f2, 0.0)
        routed = generic_stream.counts()
        want = trial.plain(alice, bob, lp, f1, f2, 0.0)
        eq = same(got, want) and routed[2:] == (1, 128)
        for f in generic_stream.CLUSTER_FRAMES:
            eq &= same(launcher(algorithm, f)[1](alice, bob, lp, f1, f2, 0.0),
                       want)
        ok &= eq
        print(f"{alg} 128 frames QBER 0.038: every group size == plain: "
              f"{eq}; unconverged {int((~got[0]).sum())}, mean iterations "
              f"{got[2].float().mean().item():.2f}; counts {routed}",
              flush=True)
    runs = {}
    for f in generic_stream.CLUSTER_FRAMES:
        plan, run = launcher(DecodingAlgorithm.NMSA, f)
        cp = plan.cluster
        clusters = min(-(-frames // f), plan.clusters)
        print(f"F={f}: C={cp.cluster}, {cp.threads} threads and "
              f"{cp.shared_bytes} shared bytes a CTA, {plan.clusters} "
              f"clusters in flight, records {cp.record_bytes} bytes a "
              f"cluster, L2 working set {cp.working_set(clusters) / 1e6:.1f}"
              f" MB", flush=True)
        runs[f] = run
    flags = fused_generic.generic_flags(DecodingAlgorithm.NMSA)
    plan = generic_stream.launch_plan(matrix, flags, dev)
    print(f"the plan takes F={plan.cluster.frames}, C={plan.cluster.cluster}",
          flush=True)

    minor = generic_stream.make_generic_stream_trial(
        matrix, DecodingAlgorithm.NMSA, CAP, False,
        generic_stream.group_for(frames, plan.resident))
    if other is not None:
        mine = launcher(DecodingAlgorithm.NMSA, None)[1]
        theirs = launcher(DecodingAlgorithm.NMSA, None, other)[1]
    for qber in POINTS:
        alice, bob, lp = keys(qber, frames, seed=int(qber * 1000))
        args = (lp, 0.8, 1.0, 0.0)
        ref = minor(alice, bob, *args)
        for f, run in runs.items():
            eq = same(run(alice, bob, *args), ref)
            ok &= eq
        series = []
        order = [("minor", minor)] + [(f"F={f}", r) for f, r in runs.items()]
        for name, fn in order + order[::-1]:
            series.append((name, timed(torch, lambda: fn(alice, bob,
                                                         *args))[1]))
        its = int(ref[2].sum())
        b = bound(frames, n, e, its, "flooding")
        if other is not None:
            eq = same(theirs(alice, bob, *args), ref)
            ok &= eq
            turns = {"against": [], "this": []}
            for name, fn in (("against", theirs), ("this", mine),
                             ("this", mine), ("against", theirs)):
                turns[name].append(timed(torch, lambda: fn(alice, bob,
                                                           *args))[1])
            a, t = (sum(v) / 2 for v in turns.values())
            print(f"QBER {qber}: the plan's cluster kernel, against / this "
                  f"(in turns A B B A): "
                  + ", ".join(f"{x:.2f}" for x in turns["against"]) + " / "
                  + ", ".join(f"{x:.2f}" for x in turns["this"])
                  + f" ms; this / against {t / a:.4f}; equal outputs: {eq}"
                  f" ({card})", flush=True)
        waste = []
        for f in runs:
            pad = -frames % f
            it = torch.cat([ref[2], ref[2].new_zeros(pad)]).view(-1, f)
            waste.append(f"F={f} {f * int(it.amax(dim=1).sum()) / its:.3f}")
        print(f"QBER {qber}: group waste (F x each group's largest iteration "
              f"count over the frames' iterations): " + ", ".join(waste),
              flush=True)
        print(f"QBER {qber}: {frames} frames, mean iterations "
              f"{its / frames:.2f}, every group size == batch-minor: {eq}; "
              + ", ".join(f"{k} {ms:.2f}" for k, ms in series)
              + f" ms; bound {b[0]:.2f} ms ({b[1]}) ({card})", flush=True)
    capped = {}
    for cap in (0, 1, 2):
        fn = generic_stream.make_generic_stream_trial(
            matrix, DecodingAlgorithm.NMSA, cap, False)
        fn(alice, bob, *args)
        capped[cap] = timed(torch, lambda: fn(alice, bob, *args), reps=3)[1]
    print(f"plan's cluster kernel caps 0/1/2 at QBER {POINTS[-1]}: "
          + ", ".join(f"{c}: {ms:.2f} ms" for c, ms in capped.items())
          + f"; one iteration of every frame {(capped[2] - capped[0]) / 2:.2f}"
          f" ms ({card})", flush=True)
    print(f"all equal: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
