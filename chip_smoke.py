#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (qkd_ldpc_v_tpu_torch).

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, and the build of every kernel from csrc/ with
   each kernel's registers and spill (nvcc -Xptxas -v).
2. Kernel vs plain: the fused QC kernel against its plain torch version on
   the same device-made keys, 512 frames each, at the headline code
   (N=10240, Z=512) and the 1k QC code (N=1024, Z=128): trial and decode
   modes, flooding and layered, NMSA/OMSA/ANMSA/AOMSA, QBER 0.03 and a
   harder QBER where some frames fail, plus cases with the message clamp;
   and, 128 frames each at cap 25, shapes that stress the kernel's layout:
   the 10k QC code with 26 base rows (N=10240, M=6656, Z=256), QC-PEG codes
   with rows of 40 edges (three words of edge bits), with Z=100 (not a warp
   multiple) and with Z=1024, trial and decode modes, both schedules, NMSA
   and AOMSA, each in its waterfall.
   Conv, keys, iterations and decisions must be exactly equal.
2b. Generic kernel vs plain: the fused generic kernel against its plain
   torch version (the generic torch decoder in float32), 512 frames each,
   on the 10k alist code (N=10240, check degrees 14-15), the 1k alist code
   with check degrees 62-63, a seeded irregular code with bit degrees 2-5
   and, at the gate's edge, a degree-2 code with N=32768 whose checks live
   in a per-block global slice: trial and decode modes, NMSA/OMSA/ANMSA/AOMSA,
   an easy QBER and a waterfall QBER where some frames fail, plus cases
   with the message clamp. Conv, keys, iterations and decisions must be
   exactly equal.
2c. Streamed QC kernel vs plain: the streamed QC kernel against its plain
   torch version (the same plain versions as the fused QC kernel's), 128
   frames each, at the N=102400 flagship (Z=2048, 150 block edges): trial
   and decode modes, flooding and layered, NMSA/OMSA/ANMSA/AOMSA, QBER 0.03
   and 0.0375 (its waterfall: some frames must fail), plus cases with the
   message clamp; the 400-block-edge N=102400 code (Z=1024) at QBER 0.03,
   NMSA and AOMSA; the R=0.36 N=102400 code (Z=1024, 64 base rows) at QBER
   0.09 and the R=0.92 one (rows of 50 edges) at QBER 0.0055, trial and
   decode, both schedules, NMSA and AOMSA; and the headline code forced
   through the streamed kernel, 512 frames, where its outputs must also
   equal the fused QC kernel's.
   Conv, keys, iterations and decisions must be exactly equal.
2d. Streamed generic kernel vs plain: the streamed generic kernel against
   its plain torch version (the fused generic kernel's), 128 frames each,
   on the N=102400 alist code: trial and decode modes, NMSA (alpha
   0.8)/OMSA/ANMSA/AOMSA, QBER 0.03 and 0.038 (its waterfall: some frames
   must fail), plus cases with the message clamp; on an N=22000 random
   regular code (column weight 3) at QBER 0.078, NMSA and AOMSA; on the
   10k alist code forced through the streamed kernel, 512 frames, where its
   outputs must also equal the fused generic kernel's; a ragged batch of 13
   100k alist frames (a full group of 8 and a short one of 5); and a mixed
   group of 8 frames where frame 0 has no errors (it must converge at once)
   and the others run to the cap. Conv, keys, iterations and decisions must
   be exactly equal.
2e. Frame kernels vs plain: the fused QC kernel's and the fused generic
   kernel's frame mode against their plain versions, 256 frames each at
   cap 50, on frames that channel.build_frames makes from real adaptation
   points with the committed untainted (.untp) pools: the headline and 1k
   QC codes (flooding and layered) and the 10k alist and degree-63 1k alist
   codes; NMSA/OMSA/ANMSA/AOMSA at an easy point and at one where some
   frames fail, the clamp at the latter; and frames whose checks around
   bit 0 have every other bit shortened (clamp off, clamp on, and primary
   factor 1.25, which brings inf and NaN), where the kernels' decode mode
   (decisions) and, on the 10k codes, the streamed kernels' decode tails
   run too. Conv, keys and iterations (and the decode mode's decisions)
   must be exactly equal, the streamed kernels' decode tails included.
2f. mc kernels vs plain: the mc modes (keys drawn in the kernel from the
   chunk's Philox stream) against ``channel.mc_channel`` and the plain
   trial, 509 frames from chunk frame 1000 (128 at N=102400): the fused QC
   kernel on the headline and 1k QC codes, both schedules,
   NMSA/OMSA/ANMSA/AOMSA, QBER 0.03 and a waterfall QBER; the streamed QC
   kernel on the flagship, both schedules, NMSA and AOMSA, QBER 0.03 and
   0.0375, and on the headline code, where it must also equal the fused QC
   kernel's mc mode; the fused generic kernel on the 10k alist and
   degree-63 1k alist codes, the four algorithms at an easy and a waterfall
   QBER, and one case with the clamp each, and, 128 frames each, NMSA and
   AOMSA on the gate's-edge degree-2 N=32768 code (checks in the global
   slice by its plan) and on the 10k alist code with its checks forced into
   the global slice, where the outputs must also equal the shared layout's.
   Conv, keys and iterations must be exactly equal.
2g. The SPA pair vs plain: (a) each elementwise step of csrc/spa.cuh
   (tanh(x * 0.5), the guarded 2 * atanh, and the two SPA-lin tables) on
   every one of the 2**32 float32 bit patterns against torch on the card,
   the differing values counted (NaN against NaN counts as equal); (b) SPA
   and SPA-lin-approx in every mode of the four kernels against their plain
   versions, cap 30, with the clamp off, at 2.5 (below the channel's |LLR|)
   and at 100: the fused QC kernel on the headline code (trial, decode, mc,
   frame), the streamed QC kernel on the flagship (trial, decode, mc) and
   on the headline code (mc, equal to the fused kernel's), the fused
   generic kernel on the 10k alist code (trial, decode, mc, frame), the
   degree-2 N=32768 code (messages in global memory) and the degree-63 1k
   alist code, the streamed generic kernel at 8 and 16 frames per group on
   the 100k alist code, a ragged batch of 13 frames and the degree-63 code
   (checks longer than its register run). Decode-mode LLRs carry a zero
   (the 0/0 ratio) in frame 0 and eight times the channel's magnitude in
   frame 1 (tanh rounds to +-1, the guard clamps); the frame mode and the
   streamed kernels' decode tails take rate-adapted frames, the
   all-shortened neighbourhood of bit 0 among them (inf and NaN). mc cases
   are held to ``mc_channel`` + the plain trial. Conv, keys, iterations and
   decisions must be exactly equal.
2h. The exact error injection's select kernel (csrc/inject.cu) vs plain:
   ``channel.inject_errors`` on the card against ``plain_inject_errors``
   (int64 keys, ``torch.kthvalue``) and NumPy's lexsort on the hard words
   of ``tests/inject_cases.py`` (equal words, words in one bin, the
   unsigned order's edges; no, one, a third, all but one and all errors;
   N = 1000 and 4099; both key widths); then at the main path's shape,
   4096 frames of 102400 bits drawn by the default key source, at the
   ``alist100k-sweep`` cell's QBERs 0.020-0.035, both widths, and through
   one ``ChunkStep`` chunk of the N=102400 alist code a QBER, which must
   launch the kernel once and run no plain version on the card. Bob's keys
   must be equal bit for bit. It prints the kernel's time beside its bounds
   (one read of the words; every byte once), the plain version's and
   ``torch.kthvalue``'s alone.
3. Main path: the CLI (``python -m qkd_ldpc_v_tpu_torch --device cuda``,
   in-process) on copies of configs/example_qc_layered.json and of its
   flooding variant, 65536 trials in 16384-frame chunks each, over the
   committed headline asset. A default run draws its keys in the kernel:
   the fused QC kernel's mc launch counter must be > 0, no trial kernel may
   launch and no plain version run on the card. Each CSV must carry the JAX
   package's columns and FER <= 0.01. The trial path then runs as a
   library caller with its own keys runs it (``qkd_ldpc_batch_simulation``
   with the default key source fed as ``key_source``: torch keys, the
   select kernel, the trial kernel), which must launch the trial kernel
   alone, at FER <= 0.01. On chunk 0 the mc kernel's statistics on the
   first 1024 frames equal the mc plain version's and the trial kernel's
   its plain version's; the mc chunk and the whole trial path are timed in
   turns (mc, trial, trial, mc), with the trial path split into keys,
   error injection and kernel. Cell 3 follows: the 1k QC asset (N=1024,
   Z=128) at QBER 0.02 and alpha 0.65 through the CLI, both schedules, 65536
   trials in 16384-frame chunks, where the fused QC mc kernel must launch
   alone at FER <= 0.01 and chunk 0's first 1024 frames equal the mc plain
   version.
3b. Generic main path: the same on a copy of
   configs/campaign_fer_1k_alist.json narrowed to QBER 0.025 (its R=0.78
   bracket, NMSA alpha 0.70, cap 100, flooding), over the committed 10k
   alist asset, through the fused generic kernel, whose launch plan it
   prints (threads, shared bytes and blocks per SM of each mode, NMSA and
   SPA-lin).
3c. 100k QC main path: the same on a copy of
   configs/campaign_fer_sweep_100k.json narrowed to the flagship asset,
   NMSA alpha 0.8, QBER 0.03, cap 100, 16384 trials in 4096-frame chunks,
   in both schedules, through the streamed QC kernel (the engine is ``qc``;
   ``simulation.qc_kernel`` picks the streamed kernel because the fused one
   cannot hold the code; the fused QC kernel must not launch), chunk 0's
   first 256 frames compared.
3f. CPU against card: the CLI on configs/example_qc_layered.json over the
   1k QC asset, 64 trials, with ``--device cpu`` (the mc plain version) and
   ``--device cuda`` (the mc kernel): the CSV rows must be equal apart from
   the throughput columns.
3d. 100k alist main path: the CLI on a copy of
   configs/campaign_fer_sweep_100k.json switched to matrix format 1 over
   the committed N=102400 alist asset, its R=0.71 bracket narrowed to QBER
   0.03 and alpha 0.8 (bench.py's stream-100k leg), cap 100, 16384 trials
   in 4096-frame chunks, flooding, through the streamed generic kernel (the
   engine is ``stream``), whose trials take its cluster kernel. The CSV
   must carry the JAX package's columns and FER <= 0.01; the streamed
   generic kernel must have launched, every launch and trial on the
   cluster kernel, the fused generic kernel not, and no plain version may
   have run on the card; chunk 0's first 256 frames must equal the plain
   version. It prints the cluster plan (frames a cluster, CTAs per
   cluster, threads and shared bytes per CTA, clusters in flight, the L2
   working set) and chunk 0's time beside its bound, checking that its
   launch took the cluster kernel with every frame; the batch-minor
   kernel's group waste (frames per group times each group's largest
   iteration count, over the iterations the frames needed), the bytes its
   design moves for the chunk and the rate that makes, its staging time
   (cap 0) and time per iteration of every group (caps 0 and 2) with the
   rate its messages move at; the cluster kernel's staging and time per
   iteration the same way; and the chunk through the cluster kernel and at
   8 and at 16 frames per group of the batch-minor kernel in turns
   (cluster, 8, 16, 16, 8, cluster), whose outputs must agree, and the same
   on its first 128 and 1024 frames.
3e. Rate-adaptive main path: the CLI on copies of
   configs/campaign_fec_measurement.json narrowed to the headline QC asset
   (its R=0.71 bracket: QBER 0.034, alpha 0.7, delta 0.1, the efficiencies
   that are kept; 16384 trials per point, through the fused QC frame
   kernel) and to the N=102400 flagship (efficiency 1.52 only, 4096 trials,
   through the streamed QC decode tail), and of
   configs/campaign_adaptive_aomsa.json switched to matrix format 1 over the
   10k alist asset (AOMSA, privacy maintenance; 16384 trials per point,
   through the fused generic frame kernel) and over the N=102400 alist asset
   (delta 0.1, efficiency 1.5, 4096 trials, through the streamed generic
   decode tail), each matrix with its .untp cache copied beside it. Every
   run prints each point's FER and chunk-timer rate; the CSV must carry the
   JAX package's rate-adaptive columns, the expected kernel must have
   launched and no other, no plain version may have run on the card, FER
   must be <= 0.01 at the largest efficiency kept, and on chunk 0 of that
   point the kernel's statistics on the first 1024 frames (256 at
   N=102400) must equal the plain version's. It also times the untainted
   greedy on the 10k alist code on the host CPU.
3g. The SPA main paths through the CLI, on config copies:
   configs/example_qc_layered.json with decoding_algorithm 0 (layered is
   asked for, so the run warns and floods: the fused QC mc mode, SPA,
   16384 frames), configs/campaign_fer_1k_alist.json with 1 over the 10k
   alist code at QBER 0.025 (the fused generic mc mode, SPA-lin, 16384),
   configs/campaign_fer_sweep_100k.json with 0 on the flagship at QBER 0.03
   (the streamed QC mc mode, SPA, 4096), the same config in format 1 over
   the 100k alist code (the streamed generic trial mode, SPA, 4096), and
   configs/campaign_fec_measurement.json with 0 on the headline code at
   efficiency 1.52 (the fused QC frame mode, SPA, 4096), one chunk each.
   Each run must launch its kernel (the mc mode where it runs, and no
   trial kernel there), no other kernel and no plain version on the card,
   at FER <= 0.01; it prints the chunk-timer and whole-call frames/s and
   the mean iterations, and chunk 0 again: its kernel time against its
   bound, with its first frames held to the plain version.
4. The library API and the resumable, traced CLI, at full width:
   (4a) ``qkd_ldpc`` on CUDA tensors: the 10k alist code, 4096 frames,
   NMSA alpha 0.70, QBER 0.025 (cell 4's point), with and without privacy
   maintenance, through the fused generic kernel's decode mode; the
   N=102400 alist code, 1024 frames, alpha 0.8, QBER 0.03, through the
   streamed generic kernel's; and the headline QC code, 4096 frames, alpha
   0.65, QBER 0.03, which must take the fused generic kernel (JAX's
   protocol decodes with its generic decoder) and not the fused QC one;
   (4b) ``qkd_ldpc_rate_adapt`` at an adaptation point of
   configs/campaign_adaptive_aomsa.json (format 1, delta 0.1, efficiency
   1.5, AOMSA, untainted puncturing from a copy of the .untp cache,
   privacy maintenance) on the 10k alist code (4096 frames) and the
   N=102400 one (1024); (4c) one SPA-lin round on the 10k alist code,
   1024 frames. Each round must launch its kernel's decode mode once and
   nothing else, with no plain version on the card, at FER <= 0.01, and
   equal exactly (syndromes_match, keys_match, iterations, alice_out,
   bob_out) the same round composed from the plain version on the card;
   it prints frames/s and the decode's time alone in turns with the whole
   round. (4d) Checkpoint and resume through the CLI: the 1k QC asset at
   QBER 0.02 and 0.03, 16384 trials each; a run stopped after its first
   combination by a progress callback that raises, then resumed, must run
   only the second combination, write the rows of an uninterrupted run
   apart from the throughput columns and delete its checkpoint. (4e)
   ``--profile`` on cell 1's config at 4 chunks of 16384 frames: the
   Chrome trace must name the fused QC mc kernel; prints the device's busy
   share of the traced window. (4f) examples/qkd_ldpc_example_torch.py
   --device cuda: the float64 decode on the card equals the oracle.
5. Distribution: two ranks, spawned (the spawn start method) after this
   process has built the kernel library, which they only load, join a gloo
   group through ``parallel.initialize_distributed`` (a localhost TCP
   coordinator) and both decode on cuda:0. Through
   ``qkd_ldpc_batch_simulation(step_factory=mesh_step_factory(...))`` they
   run cell 1's config (phase 3's layered copy: 65536 trials in 16384-frame
   chunks, the fused QC mc mode, 8192 frames a rank) gathered and reduced,
   one chunk of cell 4 (the 10k alist code, 16384 frames, the fused
   generic mc mode) and of cell 5 (the flagship, layered, 4096 frames, the
   streamed QC mc mode), each gathered and reduced, and one rate-adaptive
   chunk of cell 9's config (configs/campaign_adaptive_aomsa.json in
   format 1 over the 10k alist code, delta 0.1, efficiency 1.5, 4096
   frames, the fused generic frame mode, each rank's keys from its
   ``rank_chunk_seed`` generator). Each rank's kernel counts are set to 0
   just before each run and read just after: the expected kernel's mc (or
   frame) mode must have launched, and no other kernel or mode, with no
   plain version on the card. Gathered, rank 0's and rank 1's CSV rows
   must equal the single-rank rows apart from the throughput columns:
   phase 3's for cell 1, a single-rank run of the same config made here
   for cells 4 and 5, and for cell 9 a single-process run fed the ranks'
   draws in rank order through ``key_source``. Reduced, the counts, minima
   and maxima must be equal and the iteration mean and std within rtol
   1e-12. Then ``edge_sharded_decoder`` over the two ranks on the 10k
   alist code (256 frames, NMSA alpha 0.7, cap 100, QBER 0.025) must equal
   the generic torch decoder on the card in decisions, convergence and
   iterations. It prints, per rank, each run's decode and collective ms
   per chunk and its frames/s on two ranks, beside the single-rank
   chunk-timer frames/s.
6. Campaigns: the entry points of scripts/fer_campaign_torch.py and
   scripts/tune_factors_torch.py on the card. (6a) The 1k, 10k and 100k
   suites, 4096 trials a point (the fused generic kernel's mc mode on the
   1k alist codes, the fused QC kernel's on the 10k QC codes, the streamed
   QC kernel's on the N=102400 QC codes, all flooding, and the streamed
   generic kernel's trial mode on the N=102400 alist code); each point's
   kernel counts are set to 0 just before it and read just after: its
   kernel's mode must have launched and no other, with no plain version on
   the card. Each of the 40 points must agree with the JAX package's table
   of its suite (docs/FER_CURVES.md, docs/FER_CURVES_1K.md,
   docs/FER_CURVES_100K.md, whose alist 100k rows give way to
   docs/FER_CURVES_100K_ALIST_JAX_CPU.md, see ``fer_campaign_torch.
   JAX_TABLES``; 4096 trials each): FER within ``fer_campaign_torch.
   fer_margin`` (4 standard errors of the difference at the pooled rate,
   plus 2 frames) and, where both sides have at least 200 converged
   frames, the mean iterations within ``iters_margin`` (5 standard errors
   of the difference from the port's standard deviation), each plus half
   the table's last digit.
   It prints every point beside the table's and the margins. After a
   suite's points, outside their counts, each of its codes that no phase-2
   case decodes (the two 1k alist codes, the R=0.725 QC-PEG code, the
   R=0.84 and R=0.50 N=102400 QC codes) runs the mode its points ran
   against the plain version at the suite's alpha and one QBER in its
   waterfall, where some frames converge and some fail, 509 frames (128 at
   N=102400): conv, keys and iterations exactly equal. Every trial of the
   N=102400 alist code's points must take the streamed generic kernel's
   cluster kernel; after its suite that code prints its cluster plan and
   one 4096-frame chunk at QBER 0.03 beside its bound, on the cluster
   kernel with every frame.
   (6b) The four tuning grids on the headline QC code at QBER 0.03, 8192
   trials a point, each point through the fused QC kernel's mc mode alone;
   it prints the table and each algorithm's best point. (6c) The host's
   read of the N=102400 alist code and the untainted greedy on it, timed by
   scripts/time_host_readers.py's ``port_host_times``, the greedy equal to
   the committed .untp.
7. Result: one JSON line of kernel figures, then the last line
   ``{"ok": true, "device": {...}}``. Each kernel's ``ms`` and ``bound_ms``
   (the least time the card could take for the same work) are those of one
   main-path chunk of phase 3, 3b, 3c, 3d or 3e (``frames`` frames, layered
   where the kernel has it); ``plain_ms`` is its plain version on the timed
   case of phase 2, 2b, 2c, 2d, 2e or 2f (``plain_frames`` frames);
   ``launches`` is the main path's count. The frame and mc modes have
   entries of their own (phase 3e's chunk and count; phases 3, 3b and 3c's
   mc chunk, timed in turns, and the CLI runs' mc launches); the trial
   entries of the fused QC, fused generic and streamed QC kernels take the
   fed trial path's chunk and launches. The SPA instantiations have entries
   of their own too: phase 3g's chunk and launches, phase 2g's case for
   ``plain_ms``, and a bound with the SFU's (MUFU) operations beside the
   bytes and the f32 operations. The decode modes of the two generic
   kernels have entries of phase 4's library rounds: their launches summed
   over 4a-4c, the first round's decode for ``ms`` and ``bound_ms``, and
   the plain decode of the same round for ``plain_ms``.

It imports no JAX. Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
QC_DIR = REPO / "sparse_matrices" / "matrices_qc"
HEADLINE = QC_DIR / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx"
QC1K = QC_DIR / "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx"
FLAGSHIP = QC_DIR / "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx"
QC100K_400BE = QC_DIR / "(N=102400,M=30720,R=0.70,CW=4,Z=1024,SEED=53).mtrx"
QC100K_R036 = QC_DIR / "(N=102400,M=65536,R=0.36,CW=4,Z=1024,SEED=51).mtrx"
QC100K_R092 = QC_DIR / "(N=102400,M=8192,R=0.92,CW=4,Z=1024,SEED=55).mtrx"
ALIST_DIR = REPO / "sparse_matrices" / "matrices_alist"
ALIST10K = ALIST_DIR / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"
ALIST1K_DEG63 = ALIST_DIR / "(N=1024,M=82,R=0.92,CW=5,SEED=65).mtrx"
ALIST100K = ALIST_DIR / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx"
QC10K_ROWS26 = QC_DIR / "(N=10240,M=6656,R=0.35,CW=4,Z=256,SEED=41).mtrx"
FRAMES = 512
# Phase 2's stressing shapes: frames per case and the iteration cap.
STRESS_FRAMES = 128
STRESS_CAP = 25
THRESHOLD = 2.5
FACTORS = {"NMSA": (0.65, 1.0), "OMSA": (0.3, 1.0),
           "ANMSA": (0.88, 0.5), "AOMSA": (0.3, 0.6)}
# JAX package columns for a fixed-rate NMSA run with throughput measurement
# (qkd_ldpc_v_tpu/simulation.py::write_file).
CSV_COLUMNS = (
    "#;MATRIX_FILENAME;TYPE;R;M;N;CONFIG_QBER;ACCURATE_QBER;"
    "ITER_SUCCESS_MEAN;ITER_SUCCESS_STD;ITER_SUCCESS_MIN;ITER_SUCCESS_MAX;"
    "RATIO_SUCCESS_DEC;RATIO_SUCCESS_LDPC;FER;THROUGHPUT_MEAN;"
    "THROUGHPUT_STD;THROUGHPUT_MIN;THROUGHPUT_MAX;ALPHA"
)


# The least time the card could take for a decode (bound_ms): the larger of
# the bytes it must move (keys in, statistics out, each once) over the HBM
# rate and its f32 operations over the f32 rate without FMA (NVIDIA's H100
# SXM data sheet: 3.35 TB/s; its 67 TFLOP/s of f32 counts an FMA as two
# operations, so 33.5 T simple operations/s). Operations per edge and
# iteration that normalized min-sum needs (not the kernels' own loops, which
# do more): the bit->check message T - E 1; the two-minimum update on |m|
# 3 (max, min, min; the magnitude is an operand modifier); the sign parity
# 1 (xor of m's sign bit); the excluded minimum 2 (compare |m| with min1,
# select); the scale 1; the output sign 2 (row sign xor m's sign bit, applied
# to the magnitude); the total 1 (flooding: accumulate) or 2 (layered:
# t + (val - E)); the decision's parity 2 (total <= 0, xor).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
OPS_PER_EDGE = {"flooding": 13, "layered": 14}
# The mc modes also draw the keys: 32 integer operations per bit, 30 for
# the generator and 2 for the selection (a compare and a count per key). A
# Philox4x32-10 call is ten rounds of two 32-bit multiplies, two
# multiply-highs and two three-input XORs: 60 operations. Its key schedule
# depends only on the chunk seed, the same for every call of a launch, so
# it is no work per bit. A call gives the words of four positions, and a
# bit takes two streams: 2 * 60 / 4 = 30. One warp instruction issues per
# clock and SM sub-partition whatever its type, so the f32 and integer
# operations share the 33.5 T issue slots per second; the integer ones
# alone also need the INT32 lanes, 64 per SM (half the FP32 lanes of the
# same data sheet's 67 TFLOP/s), 132 SMs, 1.98 GHz: 16.7 T/s. The operation
# time is the larger of the two.
INT32_OPS_PER_S = 16.7e12
MC_INT_OPS_PER_BIT = 32
# The SPA pair also runs on the SFU (MUFU: exponential, reciprocal), 16
# operations per clock and SM: 16 x 132 x 1.98 GHz = 4.18 T/s. Operations
# per edge and iteration that the pair needs, counted from the machine code
# along the path a message takes (``python3 scripts/sass_torch_kernels.py
# --opcodes . spa_steps`` for the steps of csrc/spa.cu, ``... qc_stream`` for
# the division), the non-MUFU ones issued like f32 operations: the
# bit->check message T - E 1, the half 1, the term (SPA: tanhf 12 and 2 MUFU,
# EX2 and RCP; SPA-lin: the table's first segment, a compare, a multiply
# and an add, and the sign, a compare and a select, 5), the row product 1,
# the quotient (an IEEE division: 5 FFMA and FCHK, 6, and 1 MUFU, RCP), the
# guard 3 (SPA: the NaN test, max, min), the atanh (SPA: atanhf 31, its
# log1p a polynomial, and 1 MUFU, RCP; SPA-lin: the table's first segment
# and the sign, 5), the doubling 1, the total 1 and the decision's parity
# 2: SPA 59 and 4 MUFU, SPA-lin 23 and 1 MUFU.
MUFU_OPS_PER_S = 4.18e12
SPA_OPS_PER_EDGE = {"SPA": {"f32": 59, "mufu": 4},
                    "SPA_APPROX": {"f32": 23, "mufu": 1}}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, torch, reps=1):
    """(result of the last call, mean ms per call) between synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def bound(frames, n, edges, iterations, schedule, bytes_per_bit=2):
    """(bound_ms, bound_by) of a decode of ``frames`` frames whose iteration
    counts sum to ``iterations``: trial mode reads two int8 keys per bit,
    frame mode Alice's int8 frame and a float32 LLR (``bytes_per_bit`` 5);
    both write 6 bytes of statistics per frame."""
    byte_ms = (bytes_per_bit * frames * n + 6 * frames) / HBM_BYTES_PER_S * 1e3
    op_ms = OPS_PER_EDGE[schedule] * edges * iterations / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def decode_bound(frames, n, m, edges, iterations, schedule):
    """(bound_ms, bound_by) of a decode-mode launch: f32 LLRs and the
    syndrome in, decisions and 5 bytes of statistics out per frame."""
    byte_ms = frames * (5 * n + m + 5) / HBM_BYTES_PER_S * 1e3
    op_ms = OPS_PER_EDGE[schedule] * edges * iterations / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def mc_bound(frames, n, edges, iterations, schedule):
    """(bound_ms, bound_by) of an mc launch: no key bytes in, 6 bytes of
    statistics out per frame; the decode's f32 operations (``bound``) plus
    the generator's and the selection's integer operations, in the same
    issue slots and, alone, on the INT32 lanes."""
    byte_ms = 6 * frames / HBM_BYTES_PER_S * 1e3
    f32_ops = OPS_PER_EDGE[schedule] * edges * iterations
    int_ops = MC_INT_OPS_PER_BIT * frames * n
    op_ms = max((f32_ops + int_ops) / F32_OPS_PER_S,
                int_ops / INT32_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def ptxas_lines(log: str):
    """One line per compiled kernel of nvcc's -Xptxas -v report: its
    source, template flags, registers and spill stores."""
    out = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1]
        source = re.search(r"__N__[0-9a-f]+_\d+_(\w+?)_cu_", name)
        source = source.group(1) if source else name
        flags = ",".join(re.findall(r"L[bi](\d+)E", name))
        regs = next((x for x in lines[i + 1:i + 4] if "registers" in x), "")
        spill = next((x for x in lines[i + 1:i + 4] if "spill stores" in x), "")
        out.append(f"ptxas {source}<{flags}>: "
                   f"{regs.split('Used ')[-1].split(',')[0]}, "
                   f"{spill.split(',')[1].strip() if spill else '0 bytes spill stores'}")
    return out


def max_abs_diff(got, want, torch) -> int:
    diff = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
        diff = max(diff, int(d))
    return diff


def phase_kernel_vs_plain(torch, card):
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio, qc_syndrome)
    from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
        make_fused_qc_decoder, make_fused_qc_trial)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    # The second QBER of each code sits in its waterfall, so some frames
    # converge and some run to the cap.
    codes = [("headline", read_qc_matrix(HEADLINE), (0.03, 0.036)),
             ("qc1k", read_qc_matrix(QC1K), (0.03, 0.045))]
    cases = []
    for code_name, qc, qbers in codes:
        for qber in qbers:
            for schedule in ("flooding", "layered"):
                for alg in FACTORS:
                    for mode in ("trial", "decode"):
                        cases.append((code_name, qc, qber, schedule, alg,
                                      mode, False))
        # The message clamp, once per mode and schedule.
        for schedule in ("flooding", "layered"):
            for mode in ("trial", "decode"):
                cases.append((code_name, qc, qbers[1], schedule, "NMSA",
                              mode, True))

    keys = {}
    worst = 0
    headline_times = None
    failing = {}
    for i, (code_name, qc, qber, schedule, alg, mode, clamp) in enumerate(cases):
        n = qc.num_bit_nodes
        if (code_name, qber) not in keys:
            alice, bits = default_key_source(7, dev)(0, len(keys), FRAMES, n)
            ne = exact_error_count(n, qber)
            keys[(code_name, qber)] = (
                alice, inject_errors(bits, alice, ne, wide=True),
                log_ratio(ne / n))
        alice, bob, lp = keys[(code_name, qber)]
        f1, f2 = FACTORS[alg]
        thr = THRESHOLD if clamp else 0.0
        algorithm = DecodingAlgorithm[alg]
        if mode == "trial":
            fn = make_fused_qc_trial(qc, algorithm, 100, clamp, schedule)
            args = (alice, bob, lp, f1, f2, thr)
        else:
            fn = make_fused_qc_decoder(qc, algorithm, 100, clamp, schedule)
            lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
            args = (torch.where(bob == 1, -lpt, lpt), qc_syndrome(qc, alice),
                    f1, f2, thr)
        fn(*args)  # first launch of this configuration, untimed
        got, ms = timed(lambda: fn(*args), torch, reps=3)
        want, plain_ms = timed(lambda: fn.plain(*args), torch)
        got, want = tuple(got), tuple(want)
        diff = max_abs_diff(got, want, torch)
        worst = max(worst, diff)
        conv = got[0] if mode == "trial" else got[1]
        n_fail = int((~conv).sum().item())
        failing[(code_name, qber)] = failing.get((code_name, qber), 0) + n_fail
        print(f"case {i:02d} {code_name} N={n} {mode} {schedule} {alg} "
              f"qber={qber} clamp={clamp}: unconverged={n_fail}/{FRAMES} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} max_abs_err={diff}",
              flush=True)
        check(diff == 0, f"kernel != plain in case {i}")
        if (code_name, qber, schedule, alg, mode, clamp) == (
                "headline", 0.03, "layered", "NMSA", "trial", False):
            headline_times = (plain_ms, FRAMES)
        if (code_name, qber, schedule, alg, mode, clamp) == (
                "headline", 0.03, "flooding", "NMSA", "decode", False):
            b = decode_bound(FRAMES, n, qc.num_check_nodes,
                             len(qc.block_edges) * qc.lifting,
                             int(got[2].sum().item()), schedule)
            print(f"case {i:02d}: the decode mode's timed case, bound "
                  f"{b[0]:.3f} ms ({b[1]})", flush=True)
    for code_name, _, qbers in codes:
        check(failing[(code_name, qbers[1])] > 0,
              f"{code_name}: no frame failed at QBER {qbers[1]}")
    worst = max(worst, stress_shapes_vs_plain(torch, card))
    print(f"phase 2: {len(cases)} cases, kernel == plain exactly ({card})")
    return worst, headline_times


def stress_codes():
    """(name, code, QBER in its waterfall) of the shapes that stress the
    fused QC kernel's layout: the 10k QC asset with 26 base rows, a QC-PEG
    code with rows of 40 edges (three words of edge bits, longer than the
    kernel's register run), one whose Z = 100 is not a warp multiple, and
    one at Z = 1024, the kernel's largest lifting."""
    from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_peg, read_qc_matrix

    return [("rows26", read_qc_matrix(QC10K_ROWS26), 0.105),
            ("peg_deg40", generate_qc_peg(40, 3, 96, 3, seed=1), 0.004),
            ("peg_z100", generate_qc_peg(12, 4, 100, 3, seed=1), 0.04),
            ("peg_z1024", generate_qc_peg(8, 4, 1024, 3, seed=1), 0.075)]


def stress_shapes_vs_plain(torch, card):
    """Phase 2's stressing shapes: trial and decode modes, both schedules,
    NMSA and AOMSA, STRESS_FRAMES frames at cap STRESS_CAP, in each code's
    waterfall (some frames must fail); kernel == plain exactly."""
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        inject_errors, log_ratio, qc_syndrome)
    from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
        make_fused_qc_decoder, make_fused_qc_trial, shape_of)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    worst, i = 0, 0
    for name, qc, qber in stress_codes():
        n = qc.num_bit_nodes
        alice, bits = default_key_source(11, dev)(0, 0, STRESS_FRAMES, n)
        ne = int(n * qber)
        bob = inject_errors(bits, alice, ne, wide=True)
        del bits
        lp = log_ratio(ne / n)
        lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
        llr = torch.where(bob == 1, -lpt, lpt)
        syn = qc_syndrome(qc, alice)
        failed = 0
        for schedule in ("flooding", "layered"):
            for alg in ("NMSA", "AOMSA"):
                f1, f2 = FACTORS[alg]
                algorithm = DecodingAlgorithm[alg]
                for mode in ("trial", "decode"):
                    if mode == "trial":
                        fn = make_fused_qc_trial(qc, algorithm, STRESS_CAP,
                                                 False, schedule)
                        args = (alice, bob, lp, f1, f2, 0.0)
                    else:
                        fn = make_fused_qc_decoder(qc, algorithm, STRESS_CAP,
                                                   False, schedule)
                        args = (llr, syn, f1, f2, 0.0)
                    fn(*args)  # first launch of this configuration
                    got, ms = timed(lambda: fn(*args), torch)
                    want = fn.plain(*args)
                    diff = max_abs_diff(tuple(got), tuple(want), torch)
                    worst = max(worst, diff)
                    conv = got[0] if mode == "trial" else got[1]
                    n_fail = int((~conv).sum().item())
                    failed += n_fail
                    print(f"case 2-{name}-{i:02d} N={n} Z={qc.lifting} "
                          f"(mb, nb, block edges, max row degree) = "
                          f"{shape_of(qc)[:2] + shape_of(qc)[3:]} {mode} "
                          f"{schedule} {alg} qber={qber}: unconverged="
                          f"{n_fail}/{STRESS_FRAMES} kernel_ms={ms:.3f} "
                          f"max_abs_err={diff}", flush=True)
                    check(diff == 0, f"kernel != plain in case 2-{name}-{i}")
                    i += 1
        check(failed > 0, f"{name}: no frame failed at QBER {qber}")
    print(f"phase 2: {i} stressing-shape cases, kernel == plain exactly "
          f"({card})", flush=True)
    return worst


def irregular_code():
    """tests/test_pallas_generic.py::irregular_matrix: N=288, M=144, column
    weights 2..5 (seeded)."""
    import numpy as np
    from qkd_ldpc_v_tpu_torch.models.hmatrix import from_dense

    rng = np.random.default_rng(11)
    dense = np.zeros((144, 288), dtype=np.int8)
    for col in range(288):
        dense[rng.choice(144, size=2 + (col % 4), replace=False), col] = 1
    for row in range(144):
        if dense[row].sum() == 0:
            dense[row, rng.integers(0, 288)] = 1
    return from_dense(dense)


def phase_generic_vs_plain(torch, card):
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops import fused_generic
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        calculate_syndrome, exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    factors = dict(FACTORS, NMSA=(0.7, 1.0))
    # (name, code, QBERs, waterfall must fail some frames): the second QBER
    # of the first three codes sits in their waterfall.
    codes = [
        ("alist10k", read_sparse_matrix_alist(ALIST10K), (0.025, 0.032), True),
        ("alist1k_deg63", read_sparse_matrix_alist(ALIST1K_DEG63),
         (0.002, 0.004), True),
        ("irregular", irregular_code(), (0.04, 0.07), True),
        ("gate_deg2", generate_regular_ldpc(32768, 16384, 2, seed=1), (0.01,),
         False),
    ]
    cases = []
    for code_name, matrix, qbers, _ in codes:
        for qber in qbers:
            for alg in factors:
                for mode in ("trial", "decode"):
                    cases.append((code_name, matrix, qber, alg, mode, False))
        for mode in ("trial", "decode"):
            cases.append((code_name, matrix, qbers[-1], "NMSA", mode, True))

    keys = {}
    worst = 0
    times = None
    failing = {}
    for i, (code_name, matrix, qber, alg, mode, clamp) in enumerate(cases):
        n = matrix.num_bit_nodes
        if (code_name, qber) not in keys:
            alice, bits = default_key_source(11, dev)(0, len(keys), FRAMES, n)
            ne = exact_error_count(n, qber)
            keys[(code_name, qber)] = (
                alice, inject_errors(bits, alice, ne, wide=True),
                log_ratio(ne / n))
        alice, bob, lp = keys[(code_name, qber)]
        f1, f2 = factors[alg]
        thr = THRESHOLD if clamp else 0.0
        algorithm = DecodingAlgorithm[alg]
        if mode == "trial":
            fn = fused_generic.make_fused_generic_trial(matrix, algorithm, 100,
                                                        clamp)
            args = (alice, bob, lp, f1, f2, thr)
        else:
            fn = fused_generic.make_fused_generic_decoder(matrix, algorithm,
                                                          100, clamp)
            lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
            args = (torch.where(bob == 1, -lpt, lpt),
                    calculate_syndrome(layout_for(matrix), alice), f1, f2, thr)
        fn(*args)  # first launch of this configuration, untimed
        got, ms = timed(lambda: fn(*args), torch, reps=3)
        fn.plain(*args)  # first call: index tables to the card, untimed
        want, plain_ms = timed(lambda: fn.plain(*args), torch)
        got, want = tuple(got), tuple(want)
        diff = max_abs_diff(got, want, torch)
        worst = max(worst, diff)
        conv = got[0] if mode == "trial" else got[1]
        n_fail = int((~conv).sum().item())
        failing[(code_name, qber)] = failing.get((code_name, qber), 0) + n_fail
        print(f"case 2b-{i:02d} {code_name} N={n} {mode} flooding {alg} "
              f"qber={qber} clamp={clamp}: unconverged={n_fail}/{FRAMES} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} max_abs_err={diff}",
              flush=True)
        check(diff == 0, f"generic kernel != plain in case 2b-{i}")
        if (code_name, qber, alg, mode, clamp) == (
                "alist10k", 0.025, "NMSA", "trial", False):
            times = (plain_ms, FRAMES)
        if (code_name, qber, alg, mode, clamp) == (
                "alist10k", 0.025, "NMSA", "decode", False):
            b = decode_bound(FRAMES, n, matrix.num_check_nodes,
                             matrix.num_edges, int(got[2].sum().item()),
                             "flooding")
            print(f"case 2b-{i:02d}: the decode mode's timed case, bound "
                  f"{b[0]:.3f} ms ({b[1]})", flush=True)
    for code_name, _, qbers, waterfall in codes:
        if waterfall:
            check(failing[(code_name, qbers[-1])] > 0,
                  f"{code_name}: no frame failed at QBER {qbers[-1]}")
    print(f"phase 2b: {len(cases)} cases, generic kernel == plain exactly "
          f"({card})")
    return worst, times


def phase_stream_vs_plain(torch, card):
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio, qc_syndrome)
    from qkd_ldpc_v_tpu_torch.ops.fused_qc import (
        make_fused_qc_decoder, make_fused_qc_trial)
    from qkd_ldpc_v_tpu_torch.ops.qc_stream import (
        make_qc_stream_decoder, make_qc_stream_trial)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    flagship, wide, headline, r036, r092 = (
        read_qc_matrix(p) for p in
        (FLAGSHIP, QC100K_400BE, HEADLINE, QC100K_R036, QC100K_R092))
    factors = dict(FACTORS, NMSA=(0.8, 1.0))  # alpha 0.8: the flagship's
    # (name, code, frames, QBER, schedule, alg, mode, clamp); QBER 0.0375 is
    # in the flagship's waterfall and 0.036 in the headline code's.
    cases = []
    for qber in (0.03, 0.0375):
        for schedule in ("flooding", "layered"):
            for alg in factors:
                for mode in ("trial", "decode"):
                    cases.append(("flagship", flagship, 128, qber, schedule,
                                  alg, mode, False))
    for schedule in ("flooding", "layered"):
        for mode in ("trial", "decode"):
            cases.append(("flagship", flagship, 128, 0.0375, schedule,
                          "NMSA", mode, True))
    for schedule in ("flooding", "layered"):
        for alg in ("NMSA", "AOMSA"):
            cases.append(("qc100k_400be", wide, 128, 0.03, schedule, alg,
                          "trial", False))
    # The R=0.36 code (64 base rows: the largest shared share of the
    # committed assets) and the R=0.92 code (rows of 50 edges: four words
    # of edge bits and the long-check path), each at a QBER its rate holds.
    for code_name, code, qber in (("qc100k_r036", r036, 0.09),
                                  ("qc100k_r092", r092, 0.0055)):
        for schedule in ("flooding", "layered"):
            for alg in ("NMSA", "AOMSA"):
                for mode in ("trial", "decode"):
                    cases.append((code_name, code, 128, qber, schedule, alg,
                                  mode, False))
    for qber in (0.03, 0.036):
        for schedule in ("flooding", "layered"):
            for mode in ("trial", "decode"):
                cases.append(("headline", headline, FRAMES, qber, schedule,
                              "NMSA", mode, False))

    keys = {}
    worst = 0
    times = None
    failing = {}
    for i, (code_name, qc, frames, qber, schedule, alg, mode,
            clamp) in enumerate(cases):
        n = qc.num_bit_nodes
        if (code_name, qber) not in keys:
            alice, bits = default_key_source(13, dev)(0, len(keys), frames, n)
            ne = exact_error_count(n, qber)
            keys[(code_name, qber)] = (
                alice, inject_errors(bits, alice, ne, wide=True),
                log_ratio(ne / n))
        alice, bob, lp = keys[(code_name, qber)]
        f1, f2 = factors[alg]
        thr = THRESHOLD if clamp else 0.0
        algorithm = DecodingAlgorithm[alg]
        if mode == "trial":
            fn = make_qc_stream_trial(qc, algorithm, 100, clamp, schedule)
            fused = make_fused_qc_trial
            args = (alice, bob, lp, f1, f2, thr)
        else:
            fn = make_qc_stream_decoder(qc, algorithm, 100, clamp, schedule)
            fused = make_fused_qc_decoder
            lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
            args = (torch.where(bob == 1, -lpt, lpt), qc_syndrome(qc, alice),
                    f1, f2, thr)
        fn(*args)  # first launch of this configuration, untimed
        got, ms = timed(lambda: fn(*args), torch, reps=3)
        want, plain_ms = timed(lambda: fn.plain(*args), torch)
        got, want = tuple(got), tuple(want)
        diff = max_abs_diff(got, want, torch)
        if code_name == "headline":
            other = fused(qc, algorithm, 100, clamp, schedule)(*args)
            diff = max(diff, max_abs_diff(got, tuple(other), torch))
        worst = max(worst, diff)
        conv = got[0] if mode == "trial" else got[1]
        n_fail = int((~conv).sum().item())
        failing[(code_name, qber)] = failing.get((code_name, qber), 0) + n_fail
        print(f"case 2c-{i:02d} {code_name} N={n} {mode} {schedule} {alg} "
              f"qber={qber} clamp={clamp}: unconverged={n_fail}/{frames} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} max_abs_err={diff}",
              flush=True)
        check(diff == 0, f"streamed kernel != plain (or fused) in case 2c-{i}")
        if (code_name, qber, schedule, alg, mode, clamp) == (
                "flagship", 0.03, "layered", "NMSA", "trial", False):
            times = (plain_ms, frames)
    for code_name, qber in (("flagship", 0.0375), ("headline", 0.036)):
        check(failing[(code_name, qber)] > 0,
              f"{code_name}: no frame failed at QBER {qber}")
    print(f"phase 2c: {len(cases)} cases, streamed kernel == plain exactly, "
          f"== fused on the headline code ({card})")
    return worst, times


def phase_generic_stream_vs_plain(torch, card):
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        calculate_syndrome, exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    alist100k = read_sparse_matrix_alist(ALIST100K)
    regular22k = generate_regular_ldpc(22000, 11000, 3, seed=5)
    alist10k = read_sparse_matrix_alist(ALIST10K)
    factors = dict(FACTORS, NMSA=(0.8, 1.0))  # alpha 0.8: bench's 100k alist
    # (name, code, frames, QBER, alg, mode, clamp); QBER 0.038 is in the
    # 100k alist code's waterfall, 0.032 in the 10k alist code's. "mixed"
    # is one group whose frame 0 has no errors while the others, at QBER
    # 0.05, run to the cap.
    cases = []
    for qber in (0.03, 0.038):
        for alg in factors:
            for mode in ("trial", "decode"):
                cases.append(("alist100k", alist100k, 128, qber, alg, mode,
                              False))
    for mode in ("trial", "decode"):
        cases.append(("alist100k", alist100k, 128, 0.038, "NMSA", mode, True))
    for alg in ("NMSA", "AOMSA"):
        for mode in ("trial", "decode"):
            cases.append(("regular22k", regular22k, 128, 0.078, alg, mode,
                          False))
    for qber in (0.025, 0.032):
        for mode in ("trial", "decode"):
            cases.append(("alist10k", alist10k, FRAMES, qber, "NMSA", mode,
                          False))
    for mode in ("trial", "decode"):
        cases.append(("ragged", alist100k, 13, 0.038, "NMSA", mode, False))
    for alg in ("NMSA", "AOMSA"):
        for mode in ("trial", "decode"):
            cases.append(("mixed", alist100k, generic_stream.GROUPS[0],
                          0.05, alg, mode, False))

    keys = {}
    worst = 0
    times = None
    failing = {}
    for i, (code_name, matrix, frames, qber, alg, mode,
            clamp) in enumerate(cases):
        n = matrix.num_bit_nodes
        if (code_name, qber) not in keys:
            alice, bits = default_key_source(17, dev)(0, len(keys), frames, n)
            ne = exact_error_count(n, qber)
            bob = inject_errors(bits, alice, ne, wide=True)
            if code_name == "mixed":
                bob[0] = alice[0]
            keys[(code_name, qber)] = (alice, bob, log_ratio(ne / n))
            del bits
        alice, bob, lp = keys[(code_name, qber)]
        f1, f2 = (0.7, 1.0) if code_name == "alist10k" else factors[alg]
        thr = THRESHOLD if clamp else 0.0
        algorithm = DecodingAlgorithm[alg]
        if mode == "trial":
            fn = generic_stream.make_generic_stream_trial(matrix, algorithm,
                                                          100, clamp)
            fused = fused_generic.make_fused_generic_trial
            args = (alice, bob, lp, f1, f2, thr)
        else:
            fn = generic_stream.make_generic_stream_decoder(matrix, algorithm,
                                                            100, clamp)
            fused = fused_generic.make_fused_generic_decoder
            lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
            args = (torch.where(bob == 1, -lpt, lpt),
                    calculate_syndrome(layout_for(matrix), alice), f1, f2, thr)
        fn(*args)  # first launch of this configuration, untimed
        got, ms = timed(lambda: fn(*args), torch)
        fn.plain(*args)  # first call: index tables to the card, untimed
        want, plain_ms = timed(lambda: fn.plain(*args), torch)
        got, want = tuple(got), tuple(want)
        diff = max_abs_diff(got, want, torch)
        if code_name == "alist10k":
            other = fused(matrix, algorithm, 100, clamp)(*args)
            diff = max(diff, max_abs_diff(got, tuple(other), torch))
        worst = max(worst, diff)
        conv = got[0] if mode == "trial" else got[1]
        n_fail = int((~conv).sum().item())
        failing[(code_name, qber)] = failing.get((code_name, qber), 0) + n_fail
        print(f"case 2d-{i:02d} {code_name} N={n} {mode} flooding {alg} "
              f"qber={qber} clamp={clamp}: unconverged={n_fail}/{frames} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} max_abs_err={diff}",
              flush=True)
        check(diff == 0,
              f"streamed generic kernel != plain (or fused) in case 2d-{i}")
        if code_name == "mixed":
            iters = got[2].cpu()
            check(bool(conv[0]) and int(iters[0]) == 1,
                  f"case 2d-{i}: the error-free frame did not converge at once")
            check(int(iters[1:].min()) == 100,
                  f"case 2d-{i}: a frame of the mixed group left before the cap")
        if (code_name, qber, alg, mode, clamp) == (
                "alist100k", 0.03, "NMSA", "trial", False):
            times = (plain_ms, frames)
    for code_name, qber in (("alist100k", 0.038), ("alist10k", 0.032),
                            ("ragged", 0.038)):
        check(failing[(code_name, qber)] > 0,
              f"{code_name}: no frame failed at QBER {qber}")
    print(f"phase 2d: {len(cases)} cases, streamed generic kernel == plain "
          f"exactly, == fused generic on the 10k alist code ({card})")
    return worst, times


INJECT_QBERS = (0.02, 0.025, 0.03, 0.035)
INJECT_FRAMES = 4096


def phase_inject_vs_plain(torch, card):
    """Phase 2h: the select kernel against its plain version, on the hard
    words and at the main path's shape (see the module's docstring).
    Returns the kernel table's (launches, worst, chunk, case): the chunk
    steps' launches, the count of Bob's bits where kernel and plain version
    differ, summed over every comparison (each must be 0), the kernel's
    mean ms at the main path's shape with its byte bound, and the plain
    version's mean ms."""
    import itertools

    import numpy as np

    from qkd_ldpc_v_tpu_torch import simulation as tsim
    from qkd_ldpc_v_tpu_torch.config import (Config, DecodingAlgorithm,
                                             MatrixFormat)
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
    from qkd_ldpc_v_tpu_torch.ops import channel, generic_stream

    inject_cases = load_script("inject_cases", "tests")
    dev = torch.device("cuda")
    cases = list(itertools.product(inject_cases.KINDS, inject_cases.SIZES,
                                   (True, False), inject_cases.COUNTS))
    unequal = 0
    for kind, n, wide, which in cases:
        words = inject_cases.words(kind, 3, n, seed=n)
        alice = np.random.default_rng(1).integers(0, 2, (3, n), dtype=np.int8)
        ne = inject_cases.error_count(which, n)
        w, a = (torch.tensor(x, device=dev) for x in (words, alice))
        bob = channel.inject_errors(w, a, ne, wide)
        want = channel.plain_inject_errors(w, a, ne, wide)
        flips = inject_cases.expected_flips(words, ne, wide)
        unequal += int((bob != want).sum())
        check(torch.equal(bob, want)
              and (bob.cpu().numpy() ^ alice == flips).all(),
              f"phase 2h: {kind} N={n} wide={wide} {which}: kernel != plain")
    print(f"phase 2h(a): {len(cases)} hard-word cases, kernel == plain == "
          f"lexsort ({card})", flush=True)

    n, frames = 102400, INJECT_FRAMES
    words_ms = frames * n * 8 / HBM_BYTES_PER_S * 1e3
    bytes_ms = frames * n * 10 / HBM_BYTES_PER_S * 1e3
    source = tsim.default_key_source(4242, dev)
    kernel_ms, plain_ms = [], []
    for i, qber in enumerate(INJECT_QBERS):
        ne = channel.exact_error_count(n, qber)
        alice, words = source(0, i, frames, n)
        for wide in (True, False):
            channel.INJECT_COUNTS.reset()
            bob = channel.inject_errors(words, alice, ne, wide)
            want = channel.plain_inject_errors(words, alice, ne, wide)
            torch.cuda.synchronize()
            check(channel.INJECT_COUNTS.get() == (1, 1),
                  f"phase 2h: counts {channel.INJECT_COUNTS.get()}")
            unequal += int((bob != want).sum())
            check(torch.equal(bob, want), f"phase 2h: QBER {qber} wide="
                  f"{wide}: kernel != plain at {frames} x {n}")
            check(bool(((bob ^ alice).sum(dim=1) == ne).all()),
                  f"phase 2h: QBER {qber}: not {ne} flips a frame")
            del bob, want
        _, k_ms = timed(lambda: channel.inject_errors(words, alice, ne, True),
                        torch, reps=10)
        _, p_ms = timed(lambda: channel.plain_inject_errors(words, alice, ne,
                                                            True),
                        torch, reps=3)
        pos = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
        keys = ((words - (1 << 31)) << 32) | pos
        _, kth_ms = timed(lambda: torch.kthvalue(keys, ne, dim=1), torch,
                          reps=3)
        del keys
        kernel_ms.append(k_ms)
        plain_ms.append(p_ms)
        print(f"case 2h {frames} x {n} QBER {qber} ({ne} errors): kernel "
              f"{k_ms:.3f} ms (bounds: one read of the words {words_ms:.3f} "
              f"ms, every byte once {bytes_ms:.3f} ms; {bytes_ms / k_ms:.1%})"
              f", plain {p_ms:.3f} ms, torch.kthvalue alone {kth_ms:.3f} ms",
              flush=True)
        del alice, words

    matrix = read_matrix(ALIST100K, MatrixFormat.ALIST)
    cfg = Config(trials_number=frames, simulation_seed=2024,
                 decoding_algorithm=DecodingAlgorithm.NMSA,
                 decoding_alg_max_iterations=100,
                 matrix_format=MatrixFormat.ALIST, batch_size=frames,
                 use_pallas=True)
    step = tsim.ChunkStep(matrix, cfg, dev, frames)
    launches = 0
    for qber in INJECT_QBERS:
        ne = channel.exact_error_count(n, qber)
        args = tsim.ChunkArgs(sim_number=7, num_errors=ne,
                              log_p=channel.log_ratio(ne / n),
                              scalars=(0.8, 1.0, 0.0))
        channel.INJECT_COUNTS.reset()
        generic_stream.reset_counts()
        step(args, 0, frames)
        check(channel.INJECT_COUNTS.get() == (1, 0)
              and generic_stream.COUNTS.get()[:2] == (1, 0),
              f"phase 2h: chunk at QBER {qber}: injection counts "
              f"{channel.INJECT_COUNTS.get()}, trial counts "
              f"{generic_stream.COUNTS.get()}")
        launches += channel.INJECT_COUNTS.launches
        alice, bob, _ = step.chunk_keys(args, 0)
        same_alice, words = step.source(7, 0, frames, n)
        want = channel.plain_inject_errors(words, same_alice, ne, True)
        unequal += int((bob != want).sum())
        check(torch.equal(alice, same_alice) and torch.equal(bob, want),
              f"phase 2h: chunk at QBER {qber}: kernel != plain")
        del alice, bob, same_alice, words, want
    print(f"phase 2h(b): main-path shape, kernel == plain at every QBER, one "
          f"launch a chunk and no plain version on the card; {unequal} "
          f"unequal bits in all ({card})", flush=True)
    mean = sum(kernel_ms) / len(kernel_ms)
    return (launches, unequal, (mean, bytes_ms, "bytes", frames),
            (sum(plain_ms) / len(plain_ms), frames))


def read_csv(results_dir: Path):
    csvs = sorted(results_dir.glob("*.csv"))
    check(len(csvs) == 1, f"expected one CSV in {results_dir}, got {csvs}")
    lines = csvs[0].read_text().splitlines()
    check(len(lines) == 2, f"expected header + one row in {csvs[0]}")
    header = lines[0]
    check(header == CSV_COLUMNS, f"CSV columns differ: {header}")
    row = dict(zip(header.split(";"), lines[1].split(";")))
    return csvs[0], row


def run_cli(cdir: Path, matrices: Path, results: Path, device: str):
    """The CLI in-process on one config directory; its wall seconds."""
    from qkd_ldpc_v_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(["--configs", str(cdir), "--matrices", str(matrices),
                   "--results", str(results), "--device", device, "--quiet"])
    check(rc == 0, f"CLI ({cdir.name}, {device}) returned {rc}")
    return time.perf_counter() - t0


def check_mc_counts(label, kernel_mod, others):
    """After a fixed-rate main path: the mc kernel of ``kernel_mod``
    launched, no trial kernel did, no other kernel launched, and no plain
    version ran on the card. Returns the mc launches."""
    c = kernel_mod.COUNTS
    other_launches = sum(m.COUNTS.launches + m.COUNTS.mc_launches
                         for m in others)
    plain = c.plain_on_cuda + sum(m.COUNTS.plain_on_cuda for m in others)
    print(f"{label}: mc launches={c.mc_launches} trial launches={c.launches} "
          f"other kernels' launches={other_launches} plain calls on the "
          f"card={plain}", flush=True)
    check(c.mc_launches > 0, f"{label}: the mc kernel did not launch")
    check(c.launches == 0, f"{label}: a trial kernel launched")
    check(other_launches == 0, f"{label}: another kernel launched")
    check(plain == 0, f"{label}: a plain version ran on the card")
    return c.mc_launches


def trial_path_run(torch, label, path, cfg, kernel_mod):
    """The trial path as a library caller runs it: ``qkd_ldpc_batch_simulation``
    with the default key source fed as ``key_source`` (torch keys, the
    select kernel, the trial kernel). Returns its trial launches."""
    from qkd_ldpc_v_tpu_torch.simulation import (
        default_key_source, prepare_sim_inputs, qkd_ldpc_batch_simulation)

    dev = torch.device("cuda")
    sim_inputs = prepare_sim_inputs([path], cfg)
    kernel_mod.reset_counts()
    results = qkd_ldpc_batch_simulation(
        sim_inputs, cfg, dev,
        key_source=default_key_source(cfg.simulation_seed, dev))
    c = kernel_mod.COUNTS
    fer = 1.0 - results[0].ratio_trials_success_ldpc
    print(f"{label}: trial path (key_source fed): trial launches="
          f"{c.launches} mc launches={c.mc_launches} plain calls on the "
          f"card={c.plain_on_cuda} FER={fer}", flush=True)
    check(c.launches > 0 and c.mc_launches == 0 and c.plain_on_cuda == 0,
          f"{label}: the fed trial path did not run the trial kernel alone")
    check(fer <= 0.01, f"{label}: trial path FER {fer} > 0.01")
    return c.launches


def mc_and_trial_chunk(torch, card, label, mc, trial, cfg, n, ne, args, edges,
                       schedule, compared):
    """Chunk 0 of a fixed-rate main path again: the mc kernel on the whole
    chunk as the main path ran it, the mc plain version on its first
    ``compared`` frames; the same chunk through the trial path (torch keys,
    the select kernel, the trial kernel, each timed) with the trial kernel
    held to its plain version on the same frames; and the mc chunk against the
    whole trial path in turns (mc, trial, trial, mc). Returns the
    worst difference, the mc chunk (ms, bound_ms, bound_by, frames) and the
    trial kernel's (ms, bound_ms, bound_by, frames)."""
    from qkd_ldpc_v_tpu_torch.ops.channel import chunk_seed, inject_errors
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    batch = cfg.batch_size
    seed = chunk_seed(cfg.simulation_seed, 0, 0)

    def run_mc():
        return mc(seed, 0, batch, ne, *args, device=dev)

    full = run_mc()
    want = mc.plain(seed, 0, compared, ne, *args, device=dev)
    diff = max_abs_diff(tuple(t[:compared] for t in full), tuple(want), torch)
    check(diff == 0, f"{label}: chunk-0 mc kernel stats != mc plain")
    mc_iters = int(full[2].sum().item())
    del full, want

    source = default_key_source(cfg.simulation_seed, dev)
    (alice, bits), keys_ms = timed(lambda: source(0, 0, batch, n), torch)
    bob, errors_ms = timed(lambda: inject_errors(bits, alice, ne, wide=True),
                           torch)
    del bits
    tfull, kernel_ms = timed(lambda: trial(alice, bob, *args), torch)
    want = trial.plain(alice[:compared].contiguous(),
                       bob[:compared].contiguous(), *args)
    tdiff = max_abs_diff(tuple(t[:compared] for t in tfull), tuple(want),
                         torch)
    check(tdiff == 0, f"{label}: chunk-0 trial kernel stats != plain")
    trial_bound = bound(batch, n, edges, int(tfull[2].sum().item()), schedule)
    del alice, bob, tfull, want

    def run_trial_path():
        a, b = source(0, 0, batch, n)
        return trial(a, inject_errors(b, a, ne, wide=True), *args)

    turns = {"mc": [], "trial": []}
    for which in ("mc", "trial", "trial", "mc"):
        turns[which].append(timed(run_mc if which == "mc" else run_trial_path,
                                  torch)[1])
    mc_ms = sum(turns["mc"]) / 2
    path_ms = sum(turns["trial"]) / 2
    mcb = mc_bound(batch, n, edges, mc_iters, schedule)
    print(f"{label}: one {batch}-frame chunk: mc kernel {mc_ms:.2f} ms "
          f"(bound {mcb[0]:.2f} ms, {mcb[1]}; mean iterations "
          f"{mc_iters / batch:.2f}) against the trial path {path_ms:.2f} ms "
          f"in turns (mc {turns['mc'][0]:.2f}, trial {turns['trial'][0]:.2f}, "
          f"trial {turns['trial'][1]:.2f}, mc {turns['mc'][1]:.2f}); trial "
          f"path split: keys {keys_ms:.2f} ms, error injection "
          f"{errors_ms:.2f} ms, trial kernel {kernel_ms:.2f} ms (bound "
          f"{trial_bound[0]:.2f} ms, {trial_bound[1]}) (card={card})",
          flush=True)
    print(f"{label}: chunk 0 frames 0-{compared - 1}: mc kernel == mc plain, "
          f"trial kernel == plain", flush=True)
    return (max(diff, tdiff), (mc_ms, *mcb, batch),
            (kernel_ms, *trial_bound, batch))


def print_rate(label, row, cfg, n, wall, card):
    rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
    us_per_frame = n * 1e6 / float(row["THROUGHPUT_MEAN"]) - rtt_us
    fer = float(row["FER"].replace(",", "."))
    print(f"{label}: FER={fer} iter_mean={row['ITER_SUCCESS_MEAN']} "
          f"decode_frames_per_s={1e6 / us_per_frame:.0f} (chunk timers, RTT "
          f"removed) cli_wall_frames_per_s={cfg.trials_number / wall:.0f} "
          f"(whole CLI call, {wall:.1f} s) card={card}", flush=True)
    return fer


def print_generic_plan(torch, label, matrix, card):
    """The fused generic kernel's launch plan of each mode, NMSA and
    SPA-lin: threads, shared bytes, where the checks live and the blocks
    that share an SM. Min-sum's trial and mc frames must leave room for two
    blocks per SM."""
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.ops import fused_generic

    dev = torch.device("cuda")
    for alg in (DecodingAlgorithm.NMSA, DecodingAlgorithm.SPA_APPROX):
        built = fused_generic._launch_plan(
            matrix, fused_generic.generic_flags(alg), dev)
        for mode, plan in built.plans.items():
            print(f"{label}: {alg.name} {mode} plan: {plan.threads} threads, "
                  f"{plan.shared_bytes} shared bytes, checks in "
                  f"{plan.checks} memory, {built.per_sm[mode]} blocks per "
                  f"SM ({built.resident[mode]} on the card; {card})",
                  flush=True)
        if alg == DecodingAlgorithm.NMSA:
            check(built.per_sm["trial"] >= 2 and built.per_sm["mc"] >= 2,
                  f"{label}: min-sum frames do not share an SM")


def phase_generic_main_path(torch, card):
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import exact_error_count, log_ratio
    from qkd_ldpc_v_tpu_torch.simulation import prepare_sim_inputs

    work = REPO / "build" / "chip_smoke_generic"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_alist"
    matrices.mkdir(parents=True)
    (matrices / ALIST10K.name).symlink_to(ALIST10K)
    cfg = json.loads((REPO / "configs" / "campaign_fer_1k_alist.json").read_text())
    cfg["trials_number"] = 65536
    cfg["tpu"]["batch_size"] = 16384
    for bracket in cfg["code_rate_QBER_ranges"]:
        if bracket["code_rate"] == 0.78:
            bracket["QBER"] = {"begin": 0.025, "end": 0.025, "step": 0.0028}
    cdir = work / "configs"
    cdir.mkdir()
    (cdir / "run.json").write_text(json.dumps(cfg, indent=2))

    fused_generic.reset_counts()
    generic_stream.reset_counts()
    wall = run_cli(cdir, work / "sparse_matrices", work / "results", "cuda")
    launches = check_mc_counts("generic main path", fused_generic,
                               [generic_stream])

    path, row = read_csv(work / "results")
    check(row["N"] == "10240", f"N = {row['N']}")
    check(row["CONFIG_QBER"] == "0,0250", f"QBER = {row['CONFIG_QBER']}")
    check(row["ALPHA"] == "0,700", f"alpha = {row['ALPHA']}")
    run_cfg = parse_config_data(cdir / "run.json")
    fer = print_rate("generic main path", row, run_cfg, 10240, wall, card)
    check(fer <= 0.01, f"alist: FER {fer} > 0.01")
    trial_launches = trial_path_run(torch, "generic main path", ALIST10K,
                                    run_cfg, fused_generic)

    sim_in = prepare_sim_inputs([ALIST10K], run_cfg)[0]
    comb = sim_in.combinations[0]
    matrix = sim_in.matrix
    n = matrix.num_bit_nodes
    print_generic_plan(torch, "generic main path", matrix, card)
    ne = exact_error_count(n, comb.config_qber)
    alg = run_cfg.decoding_algorithm
    cap = run_cfg.decoding_alg_max_iterations
    thr_on = run_cfg.enable_msg_llr_threshold
    args = (log_ratio(ne / n), comb.scaling_factors.primary,
            comb.scaling_factors.secondary, run_cfg.msg_llr_threshold)
    diff, mc_chunk, trial_chunk = mc_and_trial_chunk(
        torch, card, "generic main path",
        fused_generic.make_fused_generic_montecarlo(matrix, alg, cap, thr_on),
        fused_generic.make_fused_generic_trial(matrix, alg, cap, thr_on),
        run_cfg, n, ne, args, matrix.num_edges, "flooding", 1024)
    print(f"generic main path: {path.name}", flush=True)
    return {"mc": (launches, diff, mc_chunk),
            "trial": (trial_launches, diff, trial_chunk)}


def phase_main_path(torch, card):
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.ops import fused_qc, qc_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import exact_error_count, log_ratio
    from qkd_ldpc_v_tpu_torch.simulation import prepare_sim_inputs

    work = REPO / "build" / "chip_smoke"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / HEADLINE.name).symlink_to(HEADLINE)
    base = json.loads((REPO / "configs" / "example_qc_layered.json").read_text())
    runs = {}
    for schedule in ("layered", "flooding"):
        cfg = json.loads(json.dumps(base))
        cfg["trials_number"] = 65536
        cfg["tpu"]["batch_size"] = 16384
        cfg["tpu"]["schedule"] = schedule
        cdir = work / f"configs_{schedule}"
        cdir.mkdir()
        (cdir / "run.json").write_text(json.dumps(cfg, indent=2))
        runs[schedule] = cdir

    fused_qc.reset_counts()
    qc_stream.reset_counts()
    walls = {schedule: run_cli(cdir, work / "sparse_matrices",
                               work / f"results_{schedule}", "cuda")
             for schedule, cdir in runs.items()}
    launches = check_mc_counts("main path", fused_qc, [qc_stream])

    worst = 0
    trial_launches = 0
    for schedule, cdir in runs.items():
        label = f"main path {schedule}"
        path, row = read_csv(work / f"results_{schedule}")
        check(row["N"] == "10240", f"N = {row['N']}")
        cfg = parse_config_data(cdir / "run.json")
        fer = print_rate(label, row, cfg, 10240, walls[schedule], card)
        check(fer <= 0.01, f"{schedule}: FER {fer} > 0.01")
        trial_launches += trial_path_run(torch, label, HEADLINE, cfg,
                                         fused_qc)

        sim_in = prepare_sim_inputs([HEADLINE], cfg)[0]
        comb = sim_in.combinations[0]
        qc = sim_in.matrix.qc
        n = qc.num_bit_nodes
        ne = exact_error_count(n, comb.config_qber)
        made = [make(qc, cfg.decoding_algorithm,
                     cfg.decoding_alg_max_iterations,
                     cfg.enable_msg_llr_threshold, cfg.schedule)
                for make in (fused_qc.make_fused_qc_montecarlo,
                             fused_qc.make_fused_qc_trial)]
        args = (log_ratio(ne / n), comb.scaling_factors.primary,
                comb.scaling_factors.secondary, cfg.msg_llr_threshold)
        diff, mc_chunk, trial_chunk = mc_and_trial_chunk(
            torch, card, label, *made, cfg, n, ne, args,
            len(qc.block_edges) * qc.lifting, schedule, 1024)
        worst = max(worst, diff)
        if schedule == "layered":
            chunks = (mc_chunk, trial_chunk)
        print(f"{label}: {path.name}", flush=True)
    worst = max(worst, cell3_main_path(torch, card))
    return {"mc": (launches, worst, chunks[0]),
            "trial": (trial_launches, worst, chunks[1])}


def cell3_main_path(torch, card):
    """Cell 3: the 1k QC asset at QBER 0.02 and alpha 0.65, both schedules,
    through the CLI on copies of configs/example_qc_layered.json, 65536
    trials in 16384-frame chunks (the fused QC mc mode, 128 threads a
    frame). The mc kernel must launch alone, with no plain version on the
    card, at FER <= 0.01; chunk 0's first 1024 frames are held to the mc
    plain version and the chunk is timed against its bound. Returns the
    worst difference."""
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.ops import fused_qc, qc_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        chunk_seed, exact_error_count, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import prepare_sim_inputs

    work = REPO / "build" / "chip_smoke_cell3"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / QC1K.name).symlink_to(QC1K)
    base = json.loads((REPO / "configs" / "example_qc_layered.json").read_text())
    base["trials_number"] = 65536
    base["tpu"]["batch_size"] = 16384
    base["code_rate_QBER_ranges"][0]["QBER"] = {"begin": 0.02, "end": 0.02,
                                                "step": 0.01}
    runs = {}
    for schedule in ("layered", "flooding"):
        cfg = json.loads(json.dumps(base))
        cfg["tpu"]["schedule"] = schedule
        cdir = work / f"configs_{schedule}"
        cdir.mkdir()
        (cdir / "run.json").write_text(json.dumps(cfg, indent=2))
        runs[schedule] = cdir
    dev = torch.device("cuda")
    worst = 0
    for schedule, cdir in runs.items():
        label = f"cell 3 {schedule}"
        fused_qc.reset_counts()
        qc_stream.reset_counts()
        wall = run_cli(cdir, work / "sparse_matrices",
                       work / f"results_{schedule}", "cuda")
        check_mc_counts(label, fused_qc, [qc_stream])
        path, row = read_csv(work / f"results_{schedule}")
        check(row["N"] == "1024", f"N = {row['N']}")
        check(row["CONFIG_QBER"] == "0,0200", f"QBER = {row['CONFIG_QBER']}")
        check(row["ALPHA"] == "0,650", f"alpha = {row['ALPHA']}")
        cfg = parse_config_data(cdir / "run.json")
        fer = print_rate(label, row, cfg, 1024, wall, card)
        check(fer <= 0.01, f"cell 3 {schedule}: FER {fer} > 0.01")
        sim_in = prepare_sim_inputs([QC1K], cfg)[0]
        comb = sim_in.combinations[0]
        qc = sim_in.matrix.qc
        n = qc.num_bit_nodes
        ne = exact_error_count(n, comb.config_qber)
        mc = fused_qc.make_fused_qc_montecarlo(
            qc, cfg.decoding_algorithm, cfg.decoding_alg_max_iterations,
            cfg.enable_msg_llr_threshold, cfg.schedule)
        args = (log_ratio(ne / n), comb.scaling_factors.primary,
                comb.scaling_factors.secondary, cfg.msg_llr_threshold)
        seed = chunk_seed(cfg.simulation_seed, 0, 0)
        batch = cfg.batch_size
        full, ms = timed(lambda: mc(seed, 0, batch, ne, *args, device=dev),
                         torch)
        want = mc.plain(seed, 0, 1024, ne, *args, device=dev)
        diff = max_abs_diff(tuple(t[:1024] for t in full), tuple(want), torch)
        check(diff == 0, f"{label}: chunk-0 mc kernel stats != mc plain")
        worst = max(worst, diff)
        iters = int(full[2].sum().item())
        b = mc_bound(batch, n, len(qc.block_edges) * qc.lifting, iters,
                     schedule)
        print(f"{label}: one {batch}-frame chunk: mc kernel {ms:.2f} ms "
              f"(bound {b[0]:.2f} ms, {b[1]}; mean iterations "
              f"{iters / batch:.2f}); chunk 0 frames 0-1023 kernel == plain "
              f"({path.name}; card={card})", flush=True)
    return worst


def phase_stream_main_path(torch, card):
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.ops import fused_qc, qc_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import exact_error_count, log_ratio
    from qkd_ldpc_v_tpu_torch.simulation import (
        prepare_sim_inputs, qc_kernel, select_engine)

    work = REPO / "build" / "chip_smoke_qc100k"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / FLAGSHIP.name).symlink_to(FLAGSHIP)
    base = json.loads(
        (REPO / "configs" / "campaign_fer_sweep_100k.json").read_text())
    base["trials_number"] = 16384
    base["tpu"]["batch_size"] = 4096
    # The flagship (R=0.70) falls in the R=0.71 bracket: QBER 0.03 and
    # alpha 0.8, bench.py's qc100k leg and this code's optimum.
    for bracket in base["code_rate_QBER_ranges"]:
        if bracket["code_rate"] == 0.71:
            bracket["QBER"] = {"begin": 0.03, "end": 0.03, "step": 0.004}
    for amap in base["min_sum_normalized_parameters"]["code_rate_alpha_maps"]:
        if amap["code_rate"] == 0.71:
            amap["alpha"] = 0.8
    runs = {}
    for schedule in ("layered", "flooding"):
        cfg = json.loads(json.dumps(base))
        cfg["tpu"]["schedule"] = schedule
        cdir = work / f"configs_{schedule}"
        cdir.mkdir()
        (cdir / "run.json").write_text(json.dumps(cfg, indent=2))
        runs[schedule] = cdir

    fused_qc.reset_counts()
    qc_stream.reset_counts()
    walls = {schedule: run_cli(cdir, work / "sparse_matrices",
                               work / f"results_{schedule}", "cuda")
             for schedule, cdir in runs.items()}
    launches = check_mc_counts("qc100k main path", qc_stream, [fused_qc])

    worst = 0
    trial_launches = 0
    for schedule, cdir in runs.items():
        label = f"qc100k main path {schedule}"
        path, row = read_csv(work / f"results_{schedule}")
        check(row["N"] == "102400", f"N = {row['N']}")
        check(row["CONFIG_QBER"] == "0,0300", f"QBER = {row['CONFIG_QBER']}")
        check(row["ALPHA"] == "0,800", f"alpha = {row['ALPHA']}")
        cfg = parse_config_data(cdir / "run.json")
        fer = print_rate(label, row, cfg, 102400, walls[schedule], card)
        check(fer <= 0.01, f"qc100k {schedule}: FER {fer} > 0.01")
        trial_launches += trial_path_run(torch, label, FLAGSHIP, cfg,
                                         qc_stream)

        sim_in = prepare_sim_inputs([FLAGSHIP], cfg)[0]
        comb = sim_in.combinations[0]
        check(qc_kernel(sim_in.matrix.qc, select_engine(sim_in.matrix, cfg),
                        schedule == "layered") == "qc_stream",
              "qc_kernel does not pick the streamed kernel")
        qc = sim_in.matrix.qc
        n = qc.num_bit_nodes
        ne = exact_error_count(n, comb.config_qber)
        made = [make(qc, cfg.decoding_algorithm,
                     cfg.decoding_alg_max_iterations,
                     cfg.enable_msg_llr_threshold, cfg.schedule)
                for make in (qc_stream.make_qc_stream_montecarlo,
                             qc_stream.make_qc_stream_trial)]
        args = (log_ratio(ne / n), comb.scaling_factors.primary,
                comb.scaling_factors.secondary, cfg.msg_llr_threshold)
        diff, mc_chunk, trial_chunk = mc_and_trial_chunk(
            torch, card, label, *made, cfg, n, ne, args,
            len(qc.block_edges) * qc.lifting, schedule, 256)
        worst = max(worst, diff)
        if schedule == "layered":
            chunks = (mc_chunk, trial_chunk)
        print(f"{label}: {path.name}", flush=True)
    return {"mc": (launches, worst, chunks[0]),
            "trial": (trial_launches, worst, chunks[1])}


def phase_cli_cpu_vs_card(torch, card):
    """A default run draws its keys from each chunk's Philox stream, on the
    CPU (the mc plain version) and on the card (the mc kernel) alike: the 1k
    QC code through the CLI with 64 trials on both devices gives the same
    CSV rows apart from the throughput columns."""
    from qkd_ldpc_v_tpu_torch.ops import fused_qc

    work = REPO / "build" / "chip_smoke_cpu_card"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / QC1K.name).symlink_to(QC1K)
    cfg = json.loads((REPO / "configs" / "example_qc_layered.json").read_text())
    cfg["trials_number"] = 64
    cdir = work / "configs"
    cdir.mkdir()
    (cdir / "run.json").write_text(json.dumps(cfg, indent=2))
    rows = {}
    for device in ("cpu", "cuda"):
        fused_qc.reset_counts()
        run_cli(cdir, work / "sparse_matrices", work / f"results_{device}",
                device)
        c = fused_qc.COUNTS
        if device == "cuda":
            routed = c.mc_launches > 0 and c.plain_on_cuda == 0
        else:
            routed = c.mc_launches == 0 and c.plain("mc") > 0
        check(routed and c.launches == 0 and c.plain("trial") == 0,
              f"CLI on {device}: mc launches {c.mc_launches}, trial "
              f"launches {c.launches}, plain calls {dict(c.plain_calls)}")
        path, row = read_csv(work / f"results_{device}")
        rows[device] = {k: v for k, v in row.items()
                        if not k.startswith("THROUGHPUT")}
        print(f"CLI on {device}: {rows[device]}", flush=True)
    check(rows["cpu"] == rows["cuda"],
          "the CPU and card CSVs differ outside the throughput columns")
    print(f"CLI 1k QC, 64 trials: the CPU and card CSV rows are equal apart "
          f"from the throughput columns ({card})", flush=True)


def cluster_route(torch, card, label, matrix, trial, alice, bob, args,
                  flags):
    """The streamed generic trial's cluster kernel on one chunk: its plan
    for ``matrix`` (frames a cluster decodes at once, CTAs per cluster,
    threads and shared bytes per CTA, clusters in flight, the L2 working
    set) and the chunk's time beside its bound, checking that the chunk's
    one launch took the cluster kernel with every frame. Returns (the
    chunk's statistics, its ms, its bound)."""
    from qkd_ldpc_v_tpu_torch.ops import generic_stream

    plan = generic_stream.launch_plan(matrix, flags, torch.device("cuda"))
    cp = plan.cluster
    check(cp is not None, f"{label}: the trial has no cluster plan")
    frames = alice.shape[0]
    clusters = min(-(-frames // cp.frames), plan.clusters)
    print(f"{label}: cluster kernel plan: {cp.frames} frames a cluster, "
          f"C={cp.cluster} CTAs of {cp.threads} threads and {cp.shared_bytes} "
          f"shared bytes, {plan.clusters} clusters in flight, L2 working set "
          f"{cp.working_set(clusters) / 1e6:.1f} MB (records "
          f"{cp.record_bytes} bytes a cluster, tables {cp.table_bytes})",
          flush=True)
    trial(alice, bob, *args)  # first launch of this configuration, untimed
    generic_stream.reset_counts()
    out, ms = timed(lambda: trial(alice, bob, *args), torch)
    counts = generic_stream.counts()
    check(counts == (1, 0, 1, frames),
          f"{label}: the chunk did not take the cluster kernel: counts "
          f"(launches, plain on the card, cluster launches, cluster frames) "
          f"{counts}")
    its = int(out[2].sum().item())
    chunk_bound = bound(frames, matrix.num_bit_nodes, matrix.num_edges, its,
                        "flooding")
    print(f"{label}: cluster kernel, one {frames}-frame chunk {ms:.2f} ms "
          f"(bound {chunk_bound[0]:.2f} ms, {chunk_bound[1]}; "
          f"{100 * chunk_bound[0] / ms:.2f} % of it), mean iterations "
          f"{its / frames:.2f}; every frame on the cluster kernel "
          f"(card={card})", flush=True)
    return out, ms, chunk_bound


def phase_generic_stream_main_path(torch, card):
    from qkd_ldpc_v_tpu_torch import cli
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import (
        default_key_source, prepare_sim_inputs, select_engine)

    work = REPO / "build" / "chip_smoke_alist100k"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_alist"
    matrices.mkdir(parents=True)
    (matrices / ALIST100K.name).symlink_to(ALIST100K)
    cfg = json.loads(
        (REPO / "configs" / "campaign_fer_sweep_100k.json").read_text())
    cfg["matrix_format"] = 1
    cfg["trials_number"] = 16384
    cfg["tpu"]["batch_size"] = 4096
    cfg["tpu"]["schedule"] = "flooding"
    # The alist code (R=0.69) falls in the R=0.71 bracket: QBER 0.03 and
    # alpha 0.8, bench.py's stream-100k leg.
    for bracket in cfg["code_rate_QBER_ranges"]:
        if bracket["code_rate"] == 0.71:
            bracket["QBER"] = {"begin": 0.03, "end": 0.03, "step": 0.004}
    for amap in cfg["min_sum_normalized_parameters"]["code_rate_alpha_maps"]:
        if amap["code_rate"] == 0.71:
            amap["alpha"] = 0.8
    cdir = work / "configs"
    cdir.mkdir()
    (cdir / "run.json").write_text(json.dumps(cfg, indent=2))

    generic_stream.reset_counts()
    fused_generic.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--configs", str(cdir), "--matrices",
                   str(work / "sparse_matrices"), "--results",
                   str(work / "results"), "--device", "cuda", "--quiet"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"CLI (alist100k) returned {rc}")
    launches, plain_on_cuda, cluster_launches, cluster_frames = \
        generic_stream.counts()
    fused_launches, fused_plain = fused_generic.counts()
    print(f"alist100k main path: streamed generic launches={launches} "
          f"(cluster kernel {cluster_launches}, {cluster_frames} frames) "
          f"fused generic launches={fused_launches} plain calls on the card="
          f"{plain_on_cuda + fused_plain}")
    check(cluster_launches == launches and cluster_frames >= cfg[
        "trials_number"], "the 100k alist main path's streamed trials did "
          "not all take the cluster kernel")
    check(launches > 0,
          "the 100k alist main path launched no streamed generic kernel")
    check(fused_launches == 0,
          "the 100k alist main path launched the fused generic kernel")
    check(plain_on_cuda + fused_plain == 0,
          "the 100k alist main path ran a plain version on the card")

    path, row = read_csv(work / "results")
    check(row["N"] == "102400", f"N = {row['N']}")
    check(row["CONFIG_QBER"] == "0,0300", f"QBER = {row['CONFIG_QBER']}")
    check(row["ALPHA"] == "0,800", f"alpha = {row['ALPHA']}")
    fer = float(row["FER"].replace(",", "."))
    check(fer <= 0.01, f"alist100k: FER {fer} > 0.01")
    run_cfg = parse_config_data(cdir / "run.json")
    rtt_us = run_cfg.rtt_ms * 1000.0 if run_cfg.consider_rtt else 0.0
    us_per_frame = 102400 * 1e6 / float(row["THROUGHPUT_MEAN"]) - rtt_us
    print(f"alist100k main path: FER={fer} "
          f"iter_mean={row['ITER_SUCCESS_MEAN']} "
          f"decode_frames_per_s={1e6 / us_per_frame:.0f} "
          f"(chunk timers, RTT removed) "
          f"cli_wall_frames_per_s={run_cfg.trials_number / wall:.0f} "
          f"(whole CLI call, {wall:.1f} s) card={card}", flush=True)

    # Chunk 0 of combination 0 again: kernel on the whole chunk as the main
    # path ran it, plain on its first 256 frames.
    dev = torch.device("cuda")
    sim_in = prepare_sim_inputs([ALIST100K], run_cfg)[0]
    comb = sim_in.combinations[0]
    matrix = sim_in.matrix
    check(select_engine(matrix, run_cfg) == "stream",
          "the 100k alist code does not select the stream engine")
    n, m, e = matrix.num_bit_nodes, matrix.num_check_nodes, matrix.num_edges
    flags = fused_generic.generic_flags(run_cfg.decoding_algorithm)
    plan = generic_stream.launch_plan(matrix, flags, dev)
    for g in generic_stream.GROUPS:  # the pinned plans, built untimed
        generic_stream.launch_plan(matrix, flags, dev, g)
    group = generic_stream.group_for(run_cfg.batch_size, plan.resident)
    for g, blocks in plan.resident.items():
        print(f"alist100k main path: F={g}: {blocks} resident blocks of "
              f"{generic_stream.THREADS} threads, "
              f"{generic_stream.shared_bytes(n, m, g)} bytes of shared "
              f"memory each")
    print(f"alist100k main path: a {run_cfg.batch_size}-frame chunk takes "
          f"F={group}")
    ne = exact_error_count(n, comb.config_qber)
    (alice, bits), keys_ms = timed(
        lambda: default_key_source(run_cfg.simulation_seed, dev)(
            0, 0, run_cfg.batch_size, n), torch)
    bob, errors_ms = timed(
        lambda: inject_errors(bits, alice, ne, wide=True), torch)
    del bits
    trials = {g: generic_stream.make_generic_stream_trial(
        matrix, run_cfg.decoding_algorithm,
        run_cfg.decoding_alg_max_iterations, run_cfg.enable_msg_llr_threshold,
        g) for g in generic_stream.GROUPS}
    trial = generic_stream.make_generic_stream_trial(
        matrix, run_cfg.decoding_algorithm,
        run_cfg.decoding_alg_max_iterations, run_cfg.enable_msg_llr_threshold)
    args = (log_ratio(ne / n), comb.scaling_factors.primary,
            comb.scaling_factors.secondary, run_cfg.msg_llr_threshold)
    full, kernel_ms, chunk_bound = cluster_route(
        torch, card, "alist100k main path", matrix, trial, alice, bob, args,
        flags)
    print(f"alist100k main path: one {run_cfg.batch_size}-frame chunk: "
          f"keys {keys_ms:.2f} ms, error injection {errors_ms:.2f} ms "
          f"(card={card})", flush=True)

    # The group design's own figures, from this chunk's iteration counts.
    # A group iterates to its slowest frame and moves whole sectors, so its
    # messages cost 16 bytes per edge and frame slot in each of its
    # iterations (check-pass read and write, bit-pass gather and scatter);
    # Bob's bit plane is read once per bit pass (F/8 bytes per bit); the
    # staging reads both keys (2N bytes per frame) and writes the first
    # messages (4E). The index tables (2.9 MB) stay in L2 and are not
    # counted.
    iters = full[2].to(torch.int64)
    for g in generic_stream.GROUPS:
        per_group = iters.view(-1, g).amax(dim=1)
        waste = g * int(per_group.sum()) / int(iters.sum())
        design_bytes = (int(per_group.sum()) * (16 * e * g + g // 8 * n)
                        + run_cfg.batch_size * (2 * n + 4 * e))
        print(f"alist100k group design F={g}: group waste {waste:.3f} "
              f"(groups' largest iteration counts x F over the frames' "
              f"iterations); design bytes {design_bytes / 1e9:.2f} GB per "
              f"chunk, floor {design_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms "
              f"at 3.35 TB/s", flush=True)
        if g == group:
            design = (waste, design_bytes)
    minor_ms = timed(lambda: trials[group](alice, bob, *args), torch)[1]
    print(f"alist100k group design F={group}: the batch-minor chunk "
          f"{minor_ms:.2f} ms, achieved {design[1] / minor_ms / 1e6:.1f} GB/s "
          f"({design[1] / minor_ms * 1e3 / HBM_BYTES_PER_S * 100:.1f} %"
          f" of 3.35 TB/s; card={card})", flush=True)
    # The batch-minor kernel's time split at the group size a chunk takes
    # there: the cap at 0 times the staging and the key compare alone; from
    # cap 0 to cap 2 every group makes two iterations (at this QBER no frame
    # converges within two), whose messages move 16 bytes per edge and frame
    # slot each.
    capped = {}
    for cap in (0, 2):
        fn = generic_stream.make_generic_stream_trial(
            matrix, run_cfg.decoding_algorithm, cap,
            run_cfg.enable_msg_llr_threshold, group)
        fn(alice, bob, *args)  # first launch of this cap, untimed
        capped[cap] = timed(lambda: fn(alice, bob, *args), torch, reps=2)[1]
    iter_ms = (capped[2] - capped[0]) / 2
    iter_bytes = -(-run_cfg.batch_size // group) * 16 * e * group
    print(f"alist100k group design F={group}: staging and key compare "
          f"{capped[0]:.2f} ms (cap 0); one iteration of every group "
          f"{iter_ms:.2f} ms (cap 2 - cap 0, halved), its messages "
          f"{iter_bytes / 1e9:.2f} GB at {iter_bytes / iter_ms / 1e6:.1f} "
          f"GB/s (card={card})", flush=True)
    # The cluster kernel's split, the same way: staging and key compare at
    # cap 0, then one iteration of every frame.
    capped = {}
    for cap in (0, 2):
        fn = generic_stream.make_generic_stream_trial(
            matrix, run_cfg.decoding_algorithm, cap,
            run_cfg.enable_msg_llr_threshold)
        fn(alice, bob, *args)  # first launch of this cap, untimed
        capped[cap] = timed(lambda: fn(alice, bob, *args), torch, reps=2)[1]
    print(f"alist100k cluster kernel: staging and key compare "
          f"{capped[0]:.2f} ms (cap 0); one iteration of every frame "
          f"{(capped[2] - capped[0]) / 2:.2f} ms (cap 2 - cap 0, halved; "
          f"card={card})", flush=True)
    # The cluster kernel and both batch-minor group sizes in turns, pinned
    # past the per-launch choice, on the chunk and on its first 128 and 1024
    # frames (16 and 128 groups of 8, under one wave).
    trials["cluster"] = trial
    for frames in (128, 1024, run_cfg.batch_size):
        series = []
        for g in ("cluster", 8, 16, 16, 8, "cluster"):
            out, ms = timed(
                lambda: trials[g](alice[:frames], bob[:frames], *args), torch)
            check(max_abs_diff(tuple(out), tuple(t[:frames] for t in full),
                               torch) == 0,
                  f"alist100k: {frames} frames at {g} != the chunk's")
            series.append((g, ms))
        print(f"alist100k streamed kernels, {frames} frames in turns: "
              + ", ".join(f"{'' if g == 'cluster' else 'F='}{g} {ms:.2f} ms"
                          for g, ms in series) + f" (card={card})",
              flush=True)

    got = [t[:256] for t in full]
    want = trial.plain(alice[:256].contiguous(), bob[:256].contiguous(),
                       *args)
    diff = max_abs_diff(got, want, torch)
    check(diff == 0, "alist100k: chunk-0 kernel stats != plain")
    print(f"alist100k main path: chunk 0 frames 0-255 kernel == plain "
          f"({path.name})")
    return launches, diff, (kernel_ms, *chunk_bound, run_cfg.batch_size)


# ---------------------------------------------------------------------------
# Rate-adapted frames (phases 2e and 3e)
# ---------------------------------------------------------------------------

# Adaptation points (QBER, delta, efficiency) per code, untainted
# puncturing from the committed .untp pools: an easy one, and one in the
# waterfall where some of 512 frames fail.
FRAME_POINTS = {
    "headline": ((0.034, 0.1, 1.52), (0.034, 0.1, 1.37)),
    "qc1k": ((0.04, 0.1, 1.6), (0.045, 0.1, 1.5)),
    "alist10k": ((0.0252, 0.1, 1.5), (0.03, 0.1, 1.4)),
    "alist1k_deg63": ((0.003, 0.05, 2.5), (0.004, 0.1, 2.1)),
}
# A primary factor above 1: on the all-shortened neighbourhood the messages
# to its bit overflow to inf, and inf - inf gives NaN.
BIG_FACTOR = 1.25
# Phase 2e's depth: frames per case and the iteration cap (the plain
# versions' time grows with the cap where frames fail).
FRAME_CASE_FRAMES = 256
FRAME_CASE_CAP = 50


def untainted_point(path, matrix, point):
    """The HMatrixParams of an adaptation point with the committed untainted
    pool of ``path`` (read, never written)."""
    import numpy as np
    from qkd_ldpc_v_tpu_torch.rate_adapt import (
        adapt_code_rate, get_punctured_bits_untainted)

    check(path.with_suffix(".untp").exists(), f"no .untp beside {path}")
    matrix.punctured_bits_untainted = get_punctured_bits_untainted(
        path, np.random.default_rng(0), matrix)
    params = adapt_code_rate(np.random.default_rng(1), matrix, *point,
                             use_untainted=True)
    check(not params.is_empty, f"{path.name}: point {point} is skipped")
    return params


def all_shortened_plan(matrix, params, bit=0):
    """``params`` with every other bit of each check on ``bit`` shortened:
    each of those checks has all its bits but ``bit`` shortened
    (tests/test_torch_fused_qc.py::all_shortened_plan)."""
    import numpy as np
    from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams

    others = {int(b) for c in matrix.bit_nodes[bit]
              for b in matrix.check_nodes[int(c)]} - {bit}
    punct = [int(p) for p in params.punctured_bits
             if int(p) not in others and int(p) != bit]
    short = sorted(({int(s) for s in params.shortened_bits} | others) - {bit})
    return HMatrixParams(punctured_bits=np.array(punct, dtype=np.int32),
                         shortened_bits=np.array(short, dtype=np.int32))


def build_chunk(torch, params, n, qber, frames, seed, sim_number, chunk):
    """(alice_frame, llr) of one chunk as the rate-adaptive main path builds
    it: the default key source's keys, errors and punctured draw, and the
    combination's frame plan."""
    import numpy as np
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        build_frames, exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source, make_frame_plan

    dev = torch.device("cuda")
    ne = exact_error_count(n, qber)
    alice, bits, punct = default_key_source(seed, dev)(
        sim_number, chunk, frames, n, punctured=True)
    bob = inject_errors(bits, alice, ne, wide=True)
    del bits
    pos_class, gather = make_frame_plan(n, params)
    return build_frames(
        alice, bob, punct, torch.tensor(pos_class == 0, device=dev),
        torch.tensor(pos_class == 1, device=dev),
        torch.tensor(gather.astype(np.int64), device=dev),
        log_ratio(ne / n), torch.float32)


def decode_tail(decode, syndrome_of):
    """The decode tail of an engine without a frame mode, with its kernel
    and with its plain version (``simulation.frame_engine_trial``)."""
    from qkd_ldpc_v_tpu_torch.ops.decoders import frame_trial

    trial = frame_trial(decode, syndrome_of)
    trial.plain = frame_trial(decode.plain, syndrome_of)
    return trial


def phase_frame_vs_plain(torch, card):
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, MatrixFormat
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops import (
        fused_generic, fused_qc, generic_stream, qc_stream)
    from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome, qc_syndrome

    codes = [("headline", HEADLINE, MatrixFormat.QC),
             ("qc1k", QC1K, MatrixFormat.QC),
             ("alist10k", ALIST10K, MatrixFormat.ALIST),
             ("alist1k_deg63", ALIST1K_DEG63, MatrixFormat.ALIST)]
    # (code, matrix, plan name, params, QBER, schedule, alg, clamp, primary
    # factor or None for the algorithm's own)
    cases = []
    for code_name, path, fmt in codes:
        matrix = read_matrix(path, fmt)
        is_qc = fmt == MatrixFormat.QC
        schedules = ("flooding", "layered") if is_qc else ("flooding",)
        easy, hard = (untainted_point(path, matrix, pt)
                      for pt in FRAME_POINTS[code_name])
        forced = all_shortened_plan(matrix, easy)
        for label, params, point in (("easy", easy, FRAME_POINTS[code_name][0]),
                                     ("waterfall", hard,
                                      FRAME_POINTS[code_name][1])):
            for schedule in schedules:
                for alg in FACTORS:
                    cases.append((code_name, matrix, label, params, point[0],
                                  schedule, alg, False, None))
                if label == "waterfall":
                    cases.append((code_name, matrix, label, params, point[0],
                                  schedule, "NMSA", True, None))
        for schedule in schedules:
            for clamp, factor in ((False, None), (True, None),
                                  (False, BIG_FACTOR)):
                cases.append((code_name, matrix, "forced", forced,
                              FRAME_POINTS[code_name][0][0], schedule,
                              "NMSA", clamp, factor))

    frames_cache = {}
    worst = {"fused_qc": 0, "fused_generic": 0}
    times = {}
    failing = {}
    for i, (code_name, matrix, label, params, qber, schedule, alg, clamp,
            factor) in enumerate(cases):
        n = matrix.num_bit_nodes
        key = (code_name, label)
        if key not in frames_cache:
            frames_cache[key] = build_chunk(torch, params, n, qber,
                                            FRAME_CASE_FRAMES, 19, 0,
                                            len(frames_cache))
        frame, llr = frames_cache[key]
        f1, f2 = FACTORS[alg]
        if matrix.qc is None and alg == "NMSA":
            f1 = 0.7
        if factor is not None:
            f1 = factor
        thr = THRESHOLD if clamp else 0.0
        algorithm = DecodingAlgorithm[alg]
        if matrix.qc is not None:
            kernel = "fused_qc"
            fn = fused_qc.make_fused_qc_frame_trial(
                matrix.qc, algorithm, FRAME_CASE_CAP, clamp, schedule)
        else:
            kernel = "fused_generic"
            fn = fused_generic.make_fused_generic_frame_trial(
                matrix, algorithm, FRAME_CASE_CAP, clamp)
        args = (frame, llr, f1, f2, thr)
        fn(*args)  # first launch of this configuration, untimed
        got, ms = timed(lambda: fn(*args), torch, reps=3)
        fn.plain(*args)  # first call: index tables to the card, untimed
        want, plain_ms = timed(lambda: fn.plain(*args), torch)
        diff = max_abs_diff(tuple(got), tuple(want), torch)
        extra = ""
        if label == "forced":
            # The forced frames also through the kernel's decode mode
            # (decisions compared) and, on the 10k codes, the streamed
            # kernels' decode tails, all held exactly.
            if matrix.qc is not None:
                syn = qc_syndrome(matrix.qc, frame)
                dec = fused_qc.make_fused_qc_decoder(
                    matrix.qc, algorithm, FRAME_CASE_CAP, clamp, schedule)
                tails = [("qc_stream", decode_tail(
                    qc_stream.make_qc_stream_decoder(
                        matrix.qc, algorithm, FRAME_CASE_CAP, clamp, schedule),
                    lambda a: qc_syndrome(matrix.qc, a)))
                         ] if code_name == "headline" else []
            else:
                layout = layout_for(matrix)
                syn = calculate_syndrome(layout, frame)
                dec = fused_generic.make_fused_generic_decoder(
                    matrix, algorithm, FRAME_CASE_CAP, clamp)
                tails = [("generic_stream", decode_tail(
                    generic_stream.make_generic_stream_decoder(
                        matrix, algorithm, FRAME_CASE_CAP, clamp),
                    lambda a: calculate_syndrome(layout, a)))
                         ] if code_name == "alist10k" else []
            d = max_abs_diff(tuple(dec(llr, syn, f1, f2, thr)),
                             tuple(dec.plain(llr, syn, f1, f2, thr)), torch)
            diff = max(diff, d)
            extra = f" decode_mode_err={d}"
            for tail_name, tail in tails:
                d = max_abs_diff(tuple(tail(*args)), tuple(tail.plain(*args)),
                                 torch)
                extra += f" {tail_name}_decode_err={d}"
                diff = max(diff, d)
        worst[kernel] = max(worst[kernel], diff)
        n_fail = int((~got[0]).sum().item())
        failing[(code_name, label)] = failing.get((code_name, label), 0) + n_fail
        fac = "" if factor is None else f" primary={factor}"
        print(f"case 2e-{i:02d} {code_name} N={n} frame {label} {schedule} "
              f"{alg}{fac} qber={qber} clamp={clamp}: unconverged={n_fail}/"
              f"{FRAME_CASE_FRAMES} kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} "
              f"max_abs_err={diff}{extra}", flush=True)
        check(diff == 0, f"frame kernel != plain in case 2e-{i}")
        if (label, schedule, alg, clamp, factor) == (
                "easy", "layered" if matrix.qc is not None else "flooding",
                "NMSA", False, None) and code_name in ("headline", "alist10k"):
            times[kernel] = (plain_ms, FRAME_CASE_FRAMES)
    for code_name, _, _ in codes:
        check(failing[(code_name, "waterfall")] > 0,
              f"{code_name}: no frame failed at its waterfall point")
    print(f"phase 2e: {len(cases)} cases, frame kernels == plain exactly "
          f"({card})")
    return worst, times


# ---------------------------------------------------------------------------
# The mc modes (phase 2f)
# ---------------------------------------------------------------------------

# Phase 2f's depth: frames per case of the fused kernels (odd, so the last
# blocks of a wave are ragged) and the chunk frame they start at.
MC_FRAMES = 509
MC_FRAME0 = 1000


def phase_mc_vs_plain(torch, card):
    """Each mc kernel against ``channel.mc_channel`` and the plain trial on
    the card, exactly (conv, keys, iterations)."""
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
    from qkd_ldpc_v_tpu_torch.ops import fused_generic, fused_qc, launch, qc_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        chunk_seed, exact_error_count, log_ratio)

    dev = torch.device("cuda")
    headline, qc1k, flagship = (read_qc_matrix(p) for p in
                                (HEADLINE, QC1K, FLAGSHIP))
    gate = generate_regular_ldpc(32768, 16384, 2, seed=1)
    alist10k, alist1k = (read_sparse_matrix_alist(p) for p in
                         (ALIST10K, ALIST1K_DEG63))
    # (kernel, code name, code, frames, QBER, schedule, alg, clamp); the
    # second QBER of each code sits in its waterfall.
    cases = []
    for name, code, qbers in (("headline", headline, (0.03, 0.036)),
                              ("qc1k", qc1k, (0.03, 0.045))):
        for qber in qbers:
            for schedule in ("flooding", "layered"):
                for alg in FACTORS:
                    cases.append(("fused_qc_mc", name, code, MC_FRAMES, qber,
                                  schedule, alg, False))
    for qber in (0.03, 0.0375):
        for schedule in ("flooding", "layered"):
            for alg in ("NMSA", "AOMSA"):
                cases.append(("qc_stream_mc", "flagship", flagship, 128, qber,
                              schedule, alg, False))
    for schedule in ("flooding", "layered"):
        cases.append(("qc_stream_mc", "headline", headline, MC_FRAMES, 0.03,
                      schedule, "NMSA", False))
    for name, code, qbers in (("alist10k", alist10k, (0.025, 0.032)),
                              ("alist1k_deg63", alist1k, (0.002, 0.004))):
        for qber in qbers:
            for alg in FACTORS:
                cases.append(("fused_generic_mc", name, code, MC_FRAMES, qber,
                              "flooding", alg, False))
        cases.append(("fused_generic_mc", name, code, MC_FRAMES, qbers[1],
                      "flooding", "NMSA", True))
    for alg in ("NMSA", "AOMSA"):
        cases.append(("fused_generic_mc", "gate_deg2", gate, 128, 0.01,
                      "flooding", alg, False))
        cases.append(("fused_generic_mc_global", "alist10k", alist10k, 128,
                      0.032, "flooding", alg, False))

    makers = {
        "fused_qc_mc": lambda code, alg, clamp, schedule:
            fused_qc.make_fused_qc_montecarlo(code, alg, 100, clamp, schedule),
        "qc_stream_mc": lambda code, alg, clamp, schedule:
            qc_stream.make_qc_stream_montecarlo(code, alg, 100, clamp,
                                                schedule),
        "fused_generic_mc": lambda code, alg, clamp, schedule:
            fused_generic.make_fused_generic_montecarlo(code, alg, 100, clamp),
        # The checks forced into the per-block global slice.
        "fused_generic_mc_global": lambda code, alg, clamp, schedule:
            launch.generic_montecarlo(
                "fused generic", fused_generic.COUNTS,
                launch.cached_plans(
                    lambda m, flags, device: fused_generic._Launch(
                        m, flags, device, "global")),
                code, alg, 100, clamp),
    }
    timed_cases = {("fused_qc_mc", "headline", 0.03, "layered"),
                   ("qc_stream_mc", "flagship", 0.03, "layered"),
                   ("fused_generic_mc", "alist10k", 0.025, "flooding")}
    worst = {k: 0 for k in makers}
    times = {}
    failing = {}
    for i, (kernel, name, code, frames, qber, schedule, alg, clamp) in \
            enumerate(cases):
        n = code.num_bit_nodes
        ne = exact_error_count(n, qber)
        f1, f2 = FACTORS[alg]
        if alg == "NMSA":
            f1 = {"flagship": 0.8, "alist10k": 0.7}.get(name, f1)
        thr = THRESHOLD if clamp else 0.0
        mc = makers[kernel](code, DecodingAlgorithm[alg], clamp, schedule)
        args = (chunk_seed(23, 0, i), MC_FRAME0, frames, ne, log_ratio(ne / n),
                f1, f2, thr)
        mc(*args, device=dev)  # first launch of this configuration, untimed
        got, ms = timed(lambda: mc(*args, device=dev), torch, reps=3)
        mc.plain(*args, device=dev)  # first call: tables to the card, untimed
        want, plain_ms = timed(lambda: mc.plain(*args, device=dev), torch)
        diff = max_abs_diff(tuple(got), tuple(want), torch)
        extra = ""
        if kernel == "qc_stream_mc" and name == "headline":
            fused = makers["fused_qc_mc"](code, DecodingAlgorithm[alg], clamp,
                                          schedule)(*args, device=dev)
            d = max_abs_diff(tuple(got), tuple(fused), torch)
            diff = max(diff, d)
            extra = f" fused_qc_mc_err={d}"
        if kernel == "fused_generic_mc_global":
            shared = makers["fused_generic_mc"](code, DecodingAlgorithm[alg],
                                                clamp, schedule)(*args,
                                                                 device=dev)
            d = max_abs_diff(tuple(got), tuple(shared), torch)
            diff = max(diff, d)
            extra = f" shared_layout_err={d}"
        worst[kernel] = max(worst[kernel], diff)
        n_fail = int((~got[0]).sum().item())
        failing[(name, qber)] = failing.get((name, qber), 0) + n_fail
        print(f"case 2f-{i:02d} {kernel} {name} N={n} {schedule} {alg} "
              f"qber={qber} clamp={clamp} frames {MC_FRAME0}-"
              f"{MC_FRAME0 + frames - 1}: unconverged={n_fail}/{frames} "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} "
              f"max_abs_err={diff}{extra}", flush=True)
        check(diff == 0, f"mc kernel != plain in case 2f-{i}")
        if (kernel, name, qber, schedule) in timed_cases and alg == "NMSA" \
                and not clamp:
            times[kernel] = (plain_ms, frames)
    for name, qber in (("headline", 0.036), ("qc1k", 0.045),
                       ("flagship", 0.0375), ("alist10k", 0.032),
                       ("alist1k_deg63", 0.004)):
        check(failing[(name, qber)] > 0, f"{name}: no frame failed at QBER "
              f"{qber}")
    worst["fused_generic_mc"] = max(worst["fused_generic_mc"],
                                    worst.pop("fused_generic_mc_global"))
    print(f"phase 2f: {len(cases)} cases, mc kernels == mc_channel + plain "
          f"trial exactly ({card})")
    return worst, times


RA_COLUMNS = ";DELTA;EFFICIENCY;PUNCT_FRACTION;SHORT_FRACTION;R_ADAPTED"


def read_rows(results_dir: Path):
    csvs = sorted(results_dir.glob("*.csv"))
    check(len(csvs) == 1, f"expected one CSV in {results_dir}, got {csvs}")
    lines = csvs[0].read_text().splitlines()
    check(len(lines) >= 2, f"no result row in {csvs[0]}")
    header = lines[0].split(";")
    return csvs[0], lines[0], [dict(zip(header, ln.split(";")))
                               for ln in lines[1:]]


def narrowed(config, code_rate, matrix_format, trials, efficiency=None):
    """A copy of a committed rate-adaptive config for one matrix: its
    format, ``trials`` trials, and optionally one efficiency (delta 0.1)
    in the adaptation bracket the code's rate falls in."""
    cfg = json.loads((REPO / "configs" / config).read_text())
    cfg["matrix_format"] = matrix_format
    cfg["trials_number"] = trials
    if efficiency is not None:
        ranges = cfg["code_rate_adaptation_parameters"][
            "code_rate_adaptation_parameters_ranges"]
        bracket = next(r for r in ranges if code_rate <= r["code_rate"])
        bracket["delta"] = {"begin": 0.1, "end": 0.1, "step": 0.05}
        bracket["efficiency"] = {"begin": efficiency, "end": efficiency,
                                 "step": 0.1}
    return cfg


def phase_rate_adaptive_main_path(torch, card):
    import numpy as np
    from qkd_ldpc_v_tpu_torch import cli
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops import (
        fused_generic, fused_qc, generic_stream, qc_stream)
    from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome, qc_syndrome
    from qkd_ldpc_v_tpu_torch.rate_adapt import select_punctured_bits_untainted
    from qkd_ldpc_v_tpu_torch.simulation import (
        prepare_sim_inputs, qc_kernel, select_engine)

    # The untainted greedy on the host CPU (every committed asset has its
    # .untp cache, so the main path only reads them).
    alist10k = read_sparse_matrix_alist(ALIST10K)
    t0 = time.perf_counter()
    pool = select_punctured_bits_untainted(np.random.default_rng(0), alist10k)
    print(f"rate-adaptive: untainted greedy on the 10k alist code: "
          f"{len(pool)} positions in {time.perf_counter() - t0:.3f} s "
          f"(host CPU)", flush=True)

    counters = {"fused_qc": fused_qc, "fused_generic": fused_generic,
                "qc_stream": qc_stream, "generic_stream": generic_stream}
    # (name, config copy, matrix, subdirectory, kernel, frames compared)
    runs = [
        ("fec_headline", narrowed("campaign_fec_measurement.json", 0.70, 4,
                                  16384), HEADLINE, "matrices_qc", "fused_qc",
         1024),
        ("aomsa_alist10k", narrowed("campaign_adaptive_aomsa.json", 0.7226, 1,
                                    16384), ALIST10K, "matrices_alist",
         "fused_generic", 1024),
        ("fec_flagship", narrowed("campaign_fec_measurement.json", 0.70, 4,
                                  4096, 1.52), FLAGSHIP, "matrices_qc",
         "qc_stream", 256),
        ("aomsa_alist100k", narrowed("campaign_adaptive_aomsa.json", 0.69, 1,
                                     4096, 1.5), ALIST100K, "matrices_alist",
         "generic_stream", 256),
    ]
    out = {}
    for name, cfg_json, path, subdir, kernel, compared in runs:
        work = REPO / "build" / f"chip_smoke_ra_{name}"
        if work.exists():
            shutil.rmtree(work)
        matrices = work / "sparse_matrices" / subdir
        matrices.mkdir(parents=True)
        (matrices / path.name).symlink_to(path)
        # The untainted cache travels with the matrix, as a copy.
        shutil.copy(path.with_suffix(".untp"),
                    matrices / path.with_suffix(".untp").name)
        cdir = work / "configs"
        cdir.mkdir()
        (cdir / "run.json").write_text(json.dumps(cfg_json, indent=2))

        for mod in counters.values():
            mod.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--configs", str(cdir), "--matrices",
                       str(work / "sparse_matrices"), "--results",
                       str(work / "results"), "--device", "cuda", "--quiet"])
        wall = time.perf_counter() - t0
        check(rc == 0, f"CLI ({name}) returned {rc}")
        counts = {k: mod.counts() for k, mod in counters.items()}
        print(f"{name}: launches " + " ".join(
            f"{k}={c[0]}" for k, c in counts.items()) + " plain calls on the "
            f"card={sum(c[1] for c in counts.values())}", flush=True)
        check(counts[kernel][0] > 0, f"{name}: {kernel} did not launch")
        check(all(c[0] == 0 for k, c in counts.items() if k != kernel),
              f"{name}: another kernel launched")
        check(all(c[1] == 0 for c in counts.values()),
              f"{name}: a plain version ran on the card")

        cfg = parse_config_data(cdir / "run.json")
        sim_in = prepare_sim_inputs([matrices / path.name], cfg)[0]
        matrix = sim_in.matrix
        n = matrix.num_bit_nodes
        engine = select_engine(matrix, cfg)
        if matrix.qc is not None:
            check(qc_kernel(matrix.qc, engine, cfg.schedule == "layered")
                  == kernel, f"{name}: qc_kernel does not pick {kernel}")
        csv, header, rows = read_rows(work / "results")
        check(RA_COLUMNS in header, f"{name}: CSV lacks {RA_COLUMNS}")
        check(len(rows) == len(sim_in.combinations),
              f"{name}: {len(rows)} rows for {len(sim_in.combinations)} "
              "combinations")
        rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
        for comb, row in zip(sim_in.combinations, rows):
            out_len = n - len(comb.matrix_params.bits_to_remove)
            us = out_len * 1e6 / float(row["THROUGHPUT_MEAN"]) - rtt_us
            print(f"{name}: QBER={row['CONFIG_QBER']} delta={row['DELTA']} "
                  f"efficiency={row['EFFICIENCY']} R_adapted="
                  f"{row['R_ADAPTED']} FER={row['FER']} iter_mean="
                  f"{row['ITER_SUCCESS_MEAN']} decode_frames_per_s="
                  f"{1e6 / us:.0f} (chunk timers, RTT removed; output key "
                  f"{out_len} bits)", flush=True)
        last = max(range(len(rows)),
                   key=lambda i: float(rows[i]["EFFICIENCY"].replace(",", ".")))
        fer = float(rows[last]["FER"].replace(",", "."))
        check(fer <= 0.01, f"{name}: FER {fer} > 0.01 at the largest "
              "efficiency kept")
        print(f"{name}: {len(rows)} points, engine {engine}, kernel {kernel}; "
              f"whole CLI call {wall:.1f} s ({cfg.trials_number} trials per "
              f"point; card={card})", flush=True)

        # Chunk 0 of the largest efficiency's combination again: the kernel
        # on the whole chunk as the main path ran it, the plain version on
        # its first frames.
        comb = sim_in.combinations[last]
        alg = cfg.decoding_algorithm
        cap = cfg.decoding_alg_max_iterations
        thr_on = cfg.enable_msg_llr_threshold
        (frame, llr), build_ms = timed(
            lambda: build_chunk(torch, comb.matrix_params, n, comb.config_qber,
                                cfg.batch_size, cfg.simulation_seed, last, 0),
            torch)
        if kernel == "fused_qc":
            trial = fused_qc.make_fused_qc_frame_trial(matrix.qc, alg, cap,
                                                       thr_on, cfg.schedule)
        elif kernel == "fused_generic":
            trial = fused_generic.make_fused_generic_frame_trial(matrix, alg,
                                                                 cap, thr_on)
        elif kernel == "qc_stream":
            trial = decode_tail(qc_stream.make_qc_stream_decoder(
                matrix.qc, alg, cap, thr_on, cfg.schedule),
                lambda a: qc_syndrome(matrix.qc, a))
        else:
            layout = layout_for(matrix)
            trial = decode_tail(generic_stream.make_generic_stream_decoder(
                matrix, alg, cap, thr_on),
                lambda a: calculate_syndrome(layout, a))
        args = (comb.scaling_factors.primary, comb.scaling_factors.secondary,
                cfg.msg_llr_threshold)
        full, kernel_ms = timed(lambda: trial(frame, llr, *args), torch)
        edges = matrix.num_edges
        chunk_bound = bound(cfg.batch_size, n, edges,
                            int(full[2].sum().item()), cfg.schedule,
                            bytes_per_bit=5)
        print(f"{name}: one {cfg.batch_size}-frame chunk: keys, errors and "
              f"frames {build_ms:.2f} ms, {kernel} "
              f"{'frame' if kernel.startswith('fused') else 'decode tail'} "
              f"{kernel_ms:.2f} ms (bound {chunk_bound[0]:.2f} ms, "
              f"{chunk_bound[1]}), mean iterations "
              f"{full[2].float().mean().item():.2f} (card={card})", flush=True)
        got = [t[:compared] for t in full]
        want = trial.plain(frame[:compared].contiguous(),
                           llr[:compared].contiguous(), *args)
        diff = max_abs_diff(got, tuple(want), torch)
        check(diff == 0, f"{name}: chunk-0 kernel stats != plain")
        print(f"{name}: chunk 0 frames 0-{compared - 1} kernel == plain "
              f"({csv.name})", flush=True)
        out[kernel] = (counts[kernel][0], diff,
                       (kernel_ms, *chunk_bound, cfg.batch_size))
        del frame, llr, full
    return out


# ---------------------------------------------------------------------------
# The SPA pair (phases 2g and 3g)
# ---------------------------------------------------------------------------

SPA_ALGS = ("SPA", "SPA_APPROX")
# The clamp off, a threshold below the channel's |LLR| (2.5 < 3.48 at QBER
# 0.03) and one above every finite message the cases make (100).
SPA_THRESHOLDS = (None, 2.5, 100.0)
# Phase 2g's iteration cap and frames per case.
SPA_CAP = 30
SPA_FRAMES = 256
# Elementwise check: 2**32 float32 bit patterns in chunks of 2**28.
SPA_CHUNK = 1 << 28


def phase_spa_steps(torch, card):
    """Phase 2g(a): each elementwise step of csrc/spa.cuh on every float32
    bit pattern against its plain torch version on the card. Returns the
    number of differing values (NaN against NaN counts as equal)."""
    from qkd_ldpc_v_tpu_torch.ops.spa import STEPS, plain_step, spa_step

    dev = torch.device("cuda")
    base = torch.arange(SPA_CHUNK, dtype=torch.int32, device=dev)
    total = 0
    for step in STEPS:
        differ, worst_ulp, nan_mismatch = 0, 0, 0
        t0 = time.perf_counter()
        for k in range((1 << 32) // SPA_CHUNK):
            bits = base + (k * SPA_CHUNK - (1 << 31))
            x = bits.view(torch.float32)
            got = spa_step(x, step)
            want = plain_step(x, step)
            gb, wb = got.view(torch.int32), want.view(torch.int32)
            both_nan = torch.isnan(got) & torch.isnan(want)
            bad = (gb != wb) & ~both_nan
            n_bad = int(bad.sum().item())
            if n_bad:
                differ += n_bad
                nan_mismatch += int((bad & (torch.isnan(got)
                                            | torch.isnan(want))).sum().item())
                ulp = (gb[bad].to(torch.int64) - wb[bad].to(torch.int64)).abs()
                worst_ulp = max(worst_ulp, int(ulp.max().item()))
            del got, want, gb, wb, both_nan, bad
        torch.cuda.synchronize()
        print(f"case 2g-a {step}: 2**32 float32 inputs, {differ} values differ "
              f"from torch (largest distance {worst_ulp} ulp, {nan_mismatch} "
              f"NaN against a number) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        total += differ
    check(total == 0, f"phase 2g(a): {total} values differ from torch")
    print(f"phase 2g(a): csrc/spa.cuh's steps == torch on every float32 input "
          f"({card})", flush=True)
    return total


def spa_keys(torch, matrix, frames, qber, index):
    """(alice, bob, log_p, llr) of one 2g input: keys from the default key
    source (seed 31), the exact error count, the channel LLRs, and two
    forced frames in llr: frame 0 with a zero LLR on bit 0 (its checks'
    terms give the ratio 0/0) and frame 1 with every LLR eight times the
    channel's (|LLR| >= 20, so tanh(m/2) rounds to +-1 and the guard
    clamps)."""
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    dev = torch.device("cuda")
    n = matrix.num_bit_nodes
    ne = exact_error_count(n, qber)
    alice, bits = default_key_source(31, dev)(0, index, frames, n)
    bob = inject_errors(bits, alice, ne, wide=True)
    lp = log_ratio(ne / n)
    lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
    llr = torch.where(bob == 1, -lpt, lpt)
    force_llrs(torch, llr)
    return alice, bob, lp, llr


def force_llrs(torch, llr):
    """The forced frames of phase 2g, in place: frame 0 takes a zero LLR on
    bit 0, frame 1 every LLR times eight."""
    llr[0, 0] = 0.0
    if llr.shape[0] > 1:
        llr[1] = llr[1] * 8.0


def spa_bound(mode, frames, matrix, iterations, alg):
    """(bound_ms, bound_by) of an SPA-pair launch of ``mode`` over
    ``frames`` frames whose iteration counts sum to ``iterations``: the
    larger of its bytes over the HBM rate (each input read once, 6 bytes
    of statistics or the decode mode's decisions written), its f32 (and,
    mc, the generator's integer) operations over the issue rate, the
    integer ones alone over the INT32 lanes, and its MUFU operations over
    the SFU rate (SPA_OPS_PER_EDGE)."""
    n, m = matrix.num_bit_nodes, matrix.num_check_nodes
    per_frame = {"trial": 2 * n + 6, "mc": 6,
                 "decode": 5 * n + m + 5}.get(mode, 5 * n + 6)
    int_ops = MC_INT_OPS_PER_BIT * frames * n if mode == "mc" else 0
    byte_ms = per_frame * frames / HBM_BYTES_PER_S * 1e3
    f32_ops, mufu_ops = (SPA_OPS_PER_EDGE[alg][k] * matrix.num_edges
                         * iterations for k in ("f32", "mufu"))
    op_ms = max((f32_ops + int_ops) / F32_OPS_PER_S,
                int_ops / INT32_OPS_PER_S,
                mufu_ops / MUFU_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def phase_spa_vs_plain(torch, card):
    """Phase 2g(b): the SPA pair in every mode of the four kernels against
    the plain versions on the card, exactly (conv, keys, iterations, and
    the decode mode's decisions)."""
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, MatrixFormat
    from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
    from qkd_ldpc_v_tpu_torch.models.hmatrix import (
        read_matrix, read_sparse_matrix_alist)
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops import (
        fused_generic, fused_qc, generic_stream, qc_stream)
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        calculate_syndrome, chunk_seed, exact_error_count, log_ratio,
        qc_syndrome)

    dev = torch.device("cuda")
    headline_h, flagship_h = (read_matrix(p, MatrixFormat.QC)
                              for p in (HEADLINE, FLAGSHIP))
    alist10k, alist1k, alist100k = (read_sparse_matrix_alist(p) for p in
                                    (ALIST10K, ALIST1K_DEG63, ALIST100K))
    deg2 = generate_regular_ldpc(32768, 16384, 2, seed=1)
    # (name, matrix, frames, QBER)
    codes = {
        "headline": (headline_h, SPA_FRAMES, 0.03),
        "flagship": (flagship_h, 128, 0.03),
        "alist10k": (alist10k, SPA_FRAMES, 0.025),
        "alist1k_deg63": (alist1k, SPA_FRAMES, 0.004),
        "gate_deg2": (deg2, SPA_FRAMES, 0.01),
        "alist100k": (alist100k, 128, 0.03),
        "ragged": (alist100k, 13, 0.03),
    }
    qcs = {"headline": headline_h.qc, "flagship": flagship_h.qc}

    def syndrome_of(name, matrix):
        if name in qcs:
            return lambda a: qc_syndrome(qcs[name], a)
        layout = layout_for(matrix)
        return lambda a: calculate_syndrome(layout, a)

    # kernel -> mode -> make(code, algorithm, cap, use_threshold); the QC
    # makers flood by default.
    makers = {
        "fused_qc": {"trial": fused_qc.make_fused_qc_trial,
                     "decode": fused_qc.make_fused_qc_decoder,
                     "mc": fused_qc.make_fused_qc_montecarlo,
                     "frame": fused_qc.make_fused_qc_frame_trial},
        "qc_stream": {"trial": qc_stream.make_qc_stream_trial,
                      "decode": qc_stream.make_qc_stream_decoder,
                      "mc": qc_stream.make_qc_stream_montecarlo},
        "fused_generic": {
            "trial": fused_generic.make_fused_generic_trial,
            "decode": fused_generic.make_fused_generic_decoder,
            "mc": fused_generic.make_fused_generic_montecarlo,
            "frame": fused_generic.make_fused_generic_frame_trial},
        "generic_stream": {
            "trial": generic_stream.make_generic_stream_trial,
            "decode": generic_stream.make_generic_stream_decoder},
    }
    for group in generic_stream.GROUPS:
        makers[f"generic_stream_f{group}"] = {
            mode: functools.partial(make, group=group)
            for mode, make in makers["generic_stream"].items()}

    # (kernel, mode, code name, threshold)
    cases = []
    for kernel, mode in (("fused_qc", "trial"), ("fused_qc", "decode"),
                         ("fused_qc", "mc"), ("fused_generic", "trial"),
                         ("fused_generic", "decode"), ("fused_generic", "mc")):
        name = "headline" if kernel == "fused_qc" else "alist10k"
        for thr in SPA_THRESHOLDS:
            cases.append((kernel, mode, name, thr))
    for mode in ("trial", "decode", "mc"):
        for thr in (None, 2.5 if mode == "trial" else 100.0):
            cases.append(("qc_stream", mode, "flagship", thr))
    cases.append(("qc_stream", "mc", "headline", None))
    for kernel, name in (("fused_generic", "gate_deg2"),
                         ("fused_generic", "alist1k_deg63")):
        cases.append((kernel, "trial", name, None))
    cases.append(("fused_generic", "mc", "gate_deg2", None))
    for group in generic_stream.GROUPS:
        kernel = f"generic_stream_f{group}"
        cases.append((kernel, "trial", "alist100k", None))
        cases.append((kernel, "decode", "alist100k", 100.0))
        cases.append((kernel, "trial", "ragged", None))
        cases.append((kernel, "trial", "alist1k_deg63", None))
    cases.append(("generic_stream_f16", "trial", "alist100k", 2.5))
    cases.append(("generic_stream", "trial", "alist100k", None))
    # Rate-adapted frames: an easy adaptation point and the all-shortened
    # neighbourhood of bit 0 (inf and NaN), through the fused kernels'
    # frame mode and, on the same frames, the streamed kernels' decode
    # tails.
    for name in ("headline", "alist10k"):
        for label in ("easy", "forced"):
            for thr in (None, 100.0):
                cases.append(("fused_qc" if name == "headline"
                              else "fused_generic", "frame", name,
                              (label, thr)))
        cases.append(("qc_stream" if name == "headline" else "generic_stream",
                      "tail", name, ("forced", None)))

    inputs = {}
    frame_inputs = {}
    worst = {}
    times = {}
    i = 0
    for kernel, mode, name, thr_spec in cases:
        for alg_name in SPA_ALGS:
            alg = DecodingAlgorithm[alg_name]
            matrix, frames, qber = codes[name]
            n = matrix.num_bit_nodes
            label = None
            thr = thr_spec
            if isinstance(thr_spec, tuple):
                label, thr = thr_spec
            thr_f = thr if thr is not None else 0.0
            extra = ""

            def make(which, kernel=kernel, code=qcs.get(name, matrix),
                     alg=alg, use_thr=thr is not None):
                return makers[kernel][which](code, alg, SPA_CAP, use_thr)

            if mode in ("frame", "tail"):
                if (name, label) not in frame_inputs:
                    path = HEADLINE if name == "headline" else ALIST10K
                    point = FRAME_POINTS[name][0]
                    params = untainted_point(path, matrix, point)
                    if label == "forced":
                        params = all_shortened_plan(matrix, params)
                    frame, llr = build_chunk(torch, params, n, point[0],
                                             SPA_FRAMES, 37, 0,
                                             len(frame_inputs))
                    if label == "easy":
                        force_llrs(torch, llr)
                    frame_inputs[(name, label)] = (frame, llr)
                frame, llr = frame_inputs[(name, label)]
                if mode == "frame":
                    fn = make("frame")
                else:
                    fn = decode_tail(make("decode"),
                                     syndrome_of(name, matrix))
                args = (frame, llr, 1.0, 1.0, thr_f)
                call = lambda: fn(*args)  # noqa: E731
                plain = lambda: fn.plain(*args)  # noqa: E731
            elif mode == "mc":
                fn = make("mc")
                ne = exact_error_count(n, qber)
                args = (chunk_seed(41, 0, i), MC_FRAME0, frames, ne,
                        log_ratio(ne / n), 1.0, 1.0, thr_f)
                call = lambda: fn(*args, device=dev)  # noqa: E731
                plain = lambda: fn.plain(*args, device=dev)  # noqa: E731
            else:
                if (name, qber) not in inputs:
                    inputs[(name, qber)] = spa_keys(torch, matrix, frames,
                                                    qber, len(inputs))
                alice, bob, lp, llr = inputs[(name, qber)]
                fn = make(mode)
                if mode == "trial":
                    args = (alice, bob, lp, 1.0, 1.0, thr_f)
                else:
                    args = (llr, syndrome_of(name, matrix)(alice), 1.0, 1.0,
                            thr_f)
                call = lambda: fn(*args)  # noqa: E731
                plain = lambda: fn.plain(*args)  # noqa: E731
            timed_as = {
                ("fused_qc", "mc", "headline", None, "SPA"): "fused_qc_spa_mc",
                ("fused_qc", "frame", "headline", ("easy", None), "SPA"):
                    "fused_qc_spa_frame",
                ("qc_stream", "mc", "flagship", None, "SPA"):
                    "qc_stream_spa_mc",
                ("fused_generic", "mc", "alist10k", None, "SPA_APPROX"):
                    "fused_generic_spa_lin_mc",
                ("generic_stream", "trial", "alist100k", None, "SPA"):
                    "generic_stream_spa",
            }.get((kernel, mode, name, thr_spec, alg_name))
            call()  # first launch of this configuration, untimed
            got, ms = timed(call, torch, reps=3)
            if timed_as:
                plain()  # first call: tables to the card, untimed
            want, plain_ms = timed(plain, torch)
            got, want = tuple(got), tuple(want)
            diff = max_abs_diff(got, want, torch)
            if kernel == "qc_stream" and name == "headline" and mode == "mc":
                fused = make("mc", "fused_qc")(*args, device=dev)
                d = max_abs_diff(got, tuple(fused), torch)
                diff = max(diff, d)
                extra = f" fused_qc_mc_err={d}"
            conv = got[1] if mode == "decode" else got[0]
            n_fail = int((~conv).sum().item())
            iters = got[2].float().mean().item()
            b = spa_bound(mode, conv.shape[0], matrix,
                          int(got[2].sum().item()), alg_name)
            base = kernel if not kernel.startswith("generic_stream") \
                else "generic_stream"
            worst[base] = max(worst.get(base, 0), diff)
            what = f"{mode} {label}" if label else mode
            print(f"case 2g-{i:02d} {kernel} {name} N={n} {what} {alg_name} "
                  f"qber={qber} threshold={thr}: unconverged={n_fail}/"
                  f"{conv.shape[0]} mean_iterations={iters:.2f} "
                  f"kernel_ms={ms:.3f} (bound {b[0]:.3f} ms, {b[1]}) "
                  f"plain_ms={plain_ms:.1f} max_abs_err={diff}{extra}",
                  flush=True)
            check(diff == 0, f"SPA kernel != plain in case 2g-{i}")
            if timed_as:
                times[timed_as] = (plain_ms, conv.shape[0])
            i += 1
    print(f"phase 2g(b): {i} SPA-pair cases of the four kernels == plain "
          f"exactly ({card})", flush=True)
    return worst, times


def spa_chunk(torch, card, label, fn, plain, kind, matrix, alg, frames,
              compared):
    """Chunk 0 of an SPA main path again, as the run made it: ``fn`` on the
    whole chunk (timed after the run's own launches), ``plain`` on its first
    ``compared`` frames, held equal. ``kind`` is "mc", "trial" (keys in) or
    "frame" (Alice's frame and f32 LLRs in). Returns (max_abs_err, (ms,
    bound_ms, bound_by, frames))."""
    full, ms = timed(fn, torch)
    want = plain(compared)
    diff = max_abs_diff(tuple(t[:compared] for t in full), tuple(want), torch)
    check(diff == 0, f"{label}: chunk-0 kernel stats != plain")
    iterations = int(full[2].sum().item())
    b = spa_bound(kind, frames, matrix, iterations, alg)
    print(f"{label}: one {frames}-frame chunk: {kind} kernel {ms:.2f} ms "
          f"(bound {b[0]:.2f} ms, {b[1]}), mean iterations "
          f"{iterations / frames:.2f}; chunk 0 frames 0-{compared - 1} kernel "
          f"== plain (card={card})", flush=True)
    return diff, (ms, *b, frames)


def phase_spa_main_path(torch, card):
    """Phase 3g: the SPA pair's main paths through the CLI at full width, on
    config copies: each run's kernel launched (mc launches where mc runs,
    no trial launch there), no other kernel and no plain version on the
    card, FER <= 0.01; chunk 0 again, timed and held to the plain version."""
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, parse_config_data
    from qkd_ldpc_v_tpu_torch.ops import (
        fused_generic, fused_qc, generic_stream, qc_stream)
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        chunk_seed, exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import (
        default_key_source, prepare_sim_inputs, select_engine)

    def fer_config(name, algorithm, trials, batch, code_rate, qber):
        cfg = json.loads((REPO / "configs" / name).read_text())
        cfg["decoding_algorithm"] = algorithm
        cfg["trials_number"] = trials
        cfg["tpu"]["batch_size"] = batch
        for bracket in cfg["code_rate_QBER_ranges"]:
            if bracket["code_rate"] == code_rate:
                bracket["QBER"] = {"begin": qber, "end": qber, "step": 0.001}
        return cfg

    sweep100k = fer_config("campaign_fer_sweep_100k.json", 0, 4096, 4096,
                           0.71, 0.03)
    alist100k_cfg = json.loads(json.dumps(sweep100k))
    alist100k_cfg["matrix_format"] = 1
    fec = narrowed("campaign_fec_measurement.json", 0.70, 4, 4096, 1.52)
    fec["decoding_algorithm"] = 0
    example = json.loads(
        (REPO / "configs" / "example_qc_layered.json").read_text())
    example.update(decoding_algorithm=0, trials_number=16384)
    example["tpu"]["batch_size"] = 16384
    # (name, config, matrix, subdirectory, kernel, mode, frames compared)
    runs = [
        ("spa_headline", example, HEADLINE, "matrices_qc", "fused_qc", "mc",
         1024),
        ("spa_lin_alist10k", fer_config("campaign_fer_1k_alist.json", 1, 16384,
                                        16384, 0.78, 0.025), ALIST10K,
         "matrices_alist", "fused_generic", "mc", 1024),
        ("spa_flagship", sweep100k, FLAGSHIP, "matrices_qc", "qc_stream", "mc",
         256),
        ("spa_alist100k", alist100k_cfg, ALIST100K, "matrices_alist",
         "generic_stream", "trial", 256),
        ("spa_fec_headline", fec, HEADLINE, "matrices_qc", "fused_qc",
         "frame", 1024),
    ]
    counters = {"fused_qc": fused_qc, "fused_generic": fused_generic,
                "qc_stream": qc_stream, "generic_stream": generic_stream}
    dev = torch.device("cuda")
    out = {}
    for name, cfg_json, path, subdir, kernel, mode, compared in runs:
        work = REPO / "build" / f"chip_smoke_{name}"
        if work.exists():
            shutil.rmtree(work)
        matrices = work / "sparse_matrices" / subdir
        matrices.mkdir(parents=True)
        (matrices / path.name).symlink_to(path)
        if cfg_json["enable_code_rate_adaptation"]:
            shutil.copy(path.with_suffix(".untp"),
                        matrices / path.with_suffix(".untp").name)
        cdir = work / "configs"
        cdir.mkdir()
        (cdir / "run.json").write_text(json.dumps(cfg_json, indent=2))

        for mod in counters.values():
            mod.reset_counts()
        wall = run_cli(cdir, work / "sparse_matrices", work / "results",
                       "cuda")
        c = counters[kernel].COUNTS
        launches = c.mc_launches if mode == "mc" else c.launches
        others = sum(m.COUNTS.launches + m.COUNTS.mc_launches
                     for k, m in counters.items() if k != kernel)
        plain_on_card = sum(m.COUNTS.plain_on_cuda for m in counters.values())
        print(f"{name}: {kernel} {mode} launches={launches} (mc "
              f"{c.mc_launches}, trial/frame/decode {c.launches}) other "
              f"kernels' launches={others} plain calls on the card="
              f"{plain_on_card}", flush=True)
        check(launches > 0, f"{name}: the {kernel} {mode} kernel did not launch")
        check(mode != "mc" or c.launches == 0,
              f"{name}: a trial kernel launched where mc runs")
        check(others == 0, f"{name}: another kernel launched")
        check(plain_on_card == 0, f"{name}: a plain version ran on the card")

        cfg = parse_config_data(cdir / "run.json")
        check(cfg.decoding_algorithm in (DecodingAlgorithm.SPA,
                                         DecodingAlgorithm.SPA_APPROX),
              f"{name}: not an SPA config")
        sim_in = prepare_sim_inputs([matrices / path.name], cfg)[0]
        matrix = sim_in.matrix
        n = matrix.num_bit_nodes
        csv, _, rows = read_rows(work / "results")
        check(len(rows) == 1, f"{name}: {len(rows)} result rows")
        row = rows[0]
        comb = sim_in.combinations[0]
        out_len = n - len(comb.matrix_params.bits_to_remove)
        rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
        us = out_len * 1e6 / float(row["THROUGHPUT_MEAN"]) - rtt_us
        fer = float(row["FER"].replace(",", "."))
        print(f"{name}: engine {select_engine(matrix, cfg)}, "
              f"{cfg.decoding_algorithm.display_name}, QBER="
              f"{row['CONFIG_QBER']} FER={fer} iter_mean="
              f"{row['ITER_SUCCESS_MEAN']} decode_frames_per_s={1e6 / us:.0f} "
              f"(chunk timers, RTT removed) cli_wall_frames_per_s="
              f"{cfg.trials_number / wall:.0f} (whole CLI call, {wall:.1f} s; "
              f"{csv.name}; card={card})", flush=True)
        check(fer <= 0.01, f"{name}: FER {fer} > 0.01")

        alg = cfg.decoding_algorithm
        cap = cfg.decoding_alg_max_iterations
        thr_on = cfg.enable_msg_llr_threshold
        batch = cfg.batch_size
        args = (comb.scaling_factors.primary, comb.scaling_factors.secondary,
                cfg.msg_llr_threshold)
        ne = exact_error_count(n, comb.config_qber)
        lp = log_ratio(ne / n)
        if mode == "mc":
            make = {"fused_qc": fused_qc.make_fused_qc_montecarlo,
                    "qc_stream": qc_stream.make_qc_stream_montecarlo}.get(kernel)
            mc = (make(matrix.qc, alg, cap, thr_on, "flooding") if make
                  else fused_generic.make_fused_generic_montecarlo(
                      matrix, alg, cap, thr_on))
            seed = chunk_seed(cfg.simulation_seed, 0, 0)
            diff, chunk = spa_chunk(
                torch, card, name,
                lambda: mc(seed, 0, batch, ne, lp, *args, device=dev),
                lambda k: mc.plain(seed, 0, k, ne, lp, *args, device=dev),
                "mc", matrix, alg.name, batch, compared)
        elif mode == "trial":
            trial = generic_stream.make_generic_stream_trial(matrix, alg, cap,
                                                             thr_on)
            alice, bits = default_key_source(cfg.simulation_seed, dev)(
                0, 0, batch, n)
            bob = inject_errors(bits, alice, ne, wide=True)
            del bits
            diff, chunk = spa_chunk(
                torch, card, name, lambda: trial(alice, bob, lp, *args),
                lambda k: trial.plain(alice[:k].contiguous(),
                                      bob[:k].contiguous(), lp, *args),
                "trial", matrix, alg.name, batch, compared)
            del alice, bob
        else:
            trial = fused_qc.make_fused_qc_frame_trial(matrix.qc, alg, cap,
                                                       thr_on, "flooding")
            frame, llr = build_chunk(torch, comb.matrix_params, n,
                                     comb.config_qber, batch,
                                     cfg.simulation_seed, 0, 0)
            diff, chunk = spa_chunk(
                torch, card, name, lambda: trial(frame, llr, *args),
                lambda k: trial.plain(frame[:k].contiguous(),
                                      llr[:k].contiguous(), *args),
                "frame", matrix, alg.name, batch, compared)
            del frame, llr
        out[name] = (launches, diff, chunk)
    return out


# ---------------------------------------------------------------------------
# The library API and the resumable, traced CLI (phase 4)
# ---------------------------------------------------------------------------

# Phase 4's depth: frames per round of the 10k and the N=102400 codes,
# trials per point of the resumed sweep (4d, one chunk each) and of the
# profiled run (4e, 4 chunks of 16384).
ROUND_FRAMES = 4096
ROUND_FRAMES_100K = 1024
RESUME_TRIALS = 16384
PROFILE_TRIALS = 65536


def kernel_modules():
    from qkd_ldpc_v_tpu_torch.ops import (
        fused_generic, fused_qc, generic_stream, qc_stream)

    return {"fused_qc": fused_qc, "qc_stream": qc_stream,
            "fused_generic": fused_generic, "generic_stream": generic_stream}


def round_keys(torch, n, qber, frames, seed):
    """Alice's keys [frames, n] and Bob's with exactly floor(n * qber)
    errors, made on the card from a seed; and the accurate QBER."""
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, generate_keys, inject_errors, random_bits)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    alice = generate_keys(gen, frames, n, dev)
    ne = exact_error_count(n, qber)
    bob = inject_errors(random_bits(gen, frames, n, dev), alice, ne, wide=True)
    return alice, bob, ne / n


def composed_frames(torch, spec, alice, bob, qber, punct):
    """(alice_frame, llr) of a round composed by hand: the keys spread over
    the frame (Alice's punctured bits at the punctured positions, 0 at the
    shortened ones) and the LLRs +-log((1-q)/q) on the payload, ALMOST_ZERO
    punctured, the largest float32 shortened."""
    import math

    import numpy as np
    from qkd_ldpc_v_tpu_torch.rate_adapt import ALMOST_ZERO

    dev = alice.device
    lp = torch.tensor(math.log((1.0 - qber) / qber), dtype=torch.float32,
                      device=dev)
    payload_llr = torch.where(bob == 1, -lp, lp)
    if not spec.rate_adaptive:
        return alice, payload_llr
    frames, n = alice.shape[0], spec.num_frame_bits
    pay, pun, sho = (torch.as_tensor(p.astype(np.int64), device=dev)
                     for p in (spec.payload_positions,
                               spec.punctured_positions,
                               spec.shortened_positions))
    frame = torch.zeros((frames, n), dtype=torch.int8, device=dev)
    frame[:, pay] = alice
    frame[:, pun] = punct
    llr = torch.zeros((frames, n), dtype=torch.float32, device=dev)
    llr[:, pay] = payload_llr
    llr[:, pun] = ALMOST_ZERO
    llr[:, sho] = torch.finfo(torch.float32).max
    return frame, llr


def protocol_round(torch, card, label, spec, kernel, frames, qber, factors,
                   seed):
    """One library round on CUDA tensors (``qkd_ldpc`` or, for a
    rate-adaptive spec, ``qkd_ldpc_rate_adapt`` with Alice's punctured bits
    fed): it must launch ``kernel``'s decode mode once and nothing else,
    with no plain version on the card, and reconcile at FER <= 0.01. Then
    the same round composed from the plain version on the card must equal
    it in every field, and the whole round and its decode launch alone are
    timed in turns (round, decode, decode, round). Returns the round's
    launches, its worst difference, the decode's (ms, bound_ms, bound_by,
    frames) and the plain decode's (ms, frames)."""
    import numpy as np
    from qkd_ldpc_v_tpu_torch import protocol
    from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome

    mods = kernel_modules()
    alice, bob, q = round_keys(torch, spec.num_key_bits, qber, frames, seed)
    punct = None
    if spec.rate_adaptive:
        gen = torch.Generator(device=alice.device)
        gen.manual_seed(seed + 1)
        punct = torch.randint(0, 2, (frames, len(spec.punctured_positions)),
                              generator=gen, dtype=torch.int8,
                              device=alice.device)

    def run_round():
        if spec.rate_adaptive:
            return protocol.qkd_ldpc_rate_adapt(spec, alice, bob, q, None,
                                                *factors, alice_punct=punct)
        return protocol.qkd_ldpc(spec, alice, bob, q, *factors)

    for mod in mods.values():
        mod.reset_counts()
    res = run_round()
    torch.cuda.synchronize()
    counts = {k: (m.COUNTS.launches, m.COUNTS.mc_launches,
                  m.COUNTS.plain_on_cuda) for k, m in mods.items()}
    print(f"{label}: launches (decode, mc, plain on the card) {counts}",
          flush=True)
    check(counts[kernel] == (1, 0, 0),
          f"{label}: {kernel}'s decode mode did not launch alone")
    check(all(c == (0, 0, 0) for k, c in counts.items() if k != kernel),
          f"{label}: another kernel launched")
    fer = 1.0 - res.keys_match.float().mean().item()
    check(fer <= 0.01, f"{label}: FER {fer} > 0.01")
    ok = res.keys_match
    check(torch.equal(res.alice_out[ok], res.bob_out[ok]),
          f"{label}: reconciled frames' outputs differ")

    decode = protocol.round_decoder(spec)
    frame, llr = composed_frames(torch, spec, alice, bob, q, punct)
    syndrome = calculate_syndrome(spec.layout, frame)
    want, plain_ms = timed(lambda: decode.plain(llr, syndrome, *factors),
                           torch)
    keep = torch.as_tensor(spec.keep.astype(np.int64), device=frame.device)
    want = (want.syndromes_match, (want.decision == frame).all(dim=1),
            want.iterations, frame[:, keep], want.decision[:, keep])
    got = (res.syndromes_match, res.keys_match, res.iterations,
           res.alice_out, res.bob_out)
    diff = max_abs_diff(got, want, torch)
    check(diff == 0, f"{label}: the round != the composed plain round")

    turns = {"round": [], "decode": []}
    for which in ("round", "decode", "decode", "round"):
        fn = (run_round if which == "round"
              else lambda: decode(llr, syndrome, *factors))
        turns[which].append(timed(fn, torch)[1])
    round_ms = sum(turns["round"]) / 2
    decode_ms = sum(turns["decode"]) / 2
    matrix = spec.matrix
    iters = int(res.iterations.sum().item())
    if spec.algorithm.name.startswith("SPA"):
        chunk_bound = spa_bound("decode", frames, matrix, iters,
                                spec.algorithm.name)
    else:
        chunk_bound = decode_bound(frames, matrix.num_bit_nodes,
                                   matrix.num_check_nodes, matrix.num_edges,
                                   iters, "flooding")
    print(f"{label}: {frames} frames, FER {fer}, mean iterations "
          f"{iters / frames:.2f}: round {round_ms:.2f} ms "
          f"({frames / round_ms * 1e3:.0f} frames/s), {kernel} decode "
          f"{decode_ms:.2f} ms ({decode_ms / round_ms:.1%} of the round; "
          f"bound {chunk_bound[0]:.3f} ms, {chunk_bound[1]}), in turns "
          f"{turns}; plain decode {plain_ms:.1f} ms; round == composed plain "
          f"round (card={card})", flush=True)
    return counts[kernel][0], diff, (decode_ms, *chunk_bound, frames), \
        (plain_ms, frames)


def adaptation_spec(name, path, rate, frames):
    """The protocol spec and scaling factors of one adaptation point of
    configs/campaign_adaptive_aomsa.json (format 1, delta 0.1, efficiency
    1.5 in the code's rate bracket; untainted puncturing from a copy of the
    committed .untp cache, privacy maintenance as the config has it)."""
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.protocol import make_protocol_spec
    from qkd_ldpc_v_tpu_torch.simulation import prepare_sim_inputs

    work = REPO / "build" / f"chip_smoke_protocol_{name}"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    (work / path.name).symlink_to(path)
    shutil.copy(path.with_suffix(".untp"), work / path.with_suffix(".untp").name)
    (work / "run.json").write_text(json.dumps(narrowed(
        "campaign_adaptive_aomsa.json", rate, 1, frames, 1.5)))
    cfg = parse_config_data(work / "run.json")
    sim_in = prepare_sim_inputs([work / path.name], cfg)[0]
    check(len(sim_in.combinations) == 1, f"{path.name}: one point expected")
    comb = sim_in.combinations[0]
    spec = make_protocol_spec(sim_in.matrix, cfg.decoding_algorithm,
                              cfg.decoding_alg_max_iterations,
                              cfg.enable_msg_llr_threshold,
                              cfg.enable_privacy_maintenance,
                              params=comb.matrix_params)
    return spec, comb.config_qber, (comb.scaling_factors.primary,
                                    comb.scaling_factors.secondary,
                                    cfg.msg_llr_threshold)


def phase_protocol(torch, card):
    """Phases 4a-4c: the library rounds at full width. Returns
    {kernel entry: (launches, worst difference, decode chunk, plain
    case)}."""
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as Alg
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.ops.fused_generic import generic_feasible
    from qkd_ldpc_v_tpu_torch.protocol import make_protocol_spec

    alist10k = read_sparse_matrix_alist(ALIST10K)
    alist100k = read_sparse_matrix_alist(ALIST100K)
    headline = read_qc_matrix(HEADLINE).to_hmatrix()
    check(generic_feasible(headline), "the headline code is outside the "
          "fused generic kernel's gate")
    rounds = [
        # 4a: fixed rate. Cell 4's point (campaign_fer_1k_alist.json: NMSA
        # alpha 0.70, cap 100) with and without privacy maintenance; cell
        # 6's (alpha 0.8, QBER 0.03); the headline QC code at cells 1-2's
        # point, through the generic kernel as JAX's protocol takes its
        # generic decoder.
        ("4a alist10k", make_protocol_spec(alist10k, Alg.NMSA, 100, False,
                                           False), "fused_generic",
         ROUND_FRAMES, 0.025, (0.70, 1.0, 0.0), "fused_generic_decode"),
        ("4a alist10k privacy", make_protocol_spec(alist10k, Alg.NMSA, 100,
                                                   False, True),
         "fused_generic", ROUND_FRAMES, 0.025, (0.70, 1.0, 0.0),
         "fused_generic_decode"),
        ("4a alist100k", make_protocol_spec(alist100k, Alg.NMSA, 100, False,
                                            False), "generic_stream",
         ROUND_FRAMES_100K, 0.03, (0.8, 1.0, 0.0), "generic_stream_decode"),
        ("4a headline QC", make_protocol_spec(headline, Alg.NMSA, 100, False,
                                              False), "fused_generic",
         ROUND_FRAMES, 0.03, (0.65, 1.0, 0.0), "fused_generic_decode"),
    ]
    # 4b: rate adaptive, AOMSA, at an adaptation point of the config.
    for name, path, rate, frames, kernel, entry in (
            ("alist10k", ALIST10K, 0.7226, ROUND_FRAMES, "fused_generic",
             "fused_generic_decode"),
            ("alist100k", ALIST100K, 0.69, ROUND_FRAMES_100K,
             "generic_stream", "generic_stream_decode")):
        spec, qber, factors = adaptation_spec(name, path, rate, frames)
        rounds.append((f"4b {name}", spec, kernel, frames, qber, factors,
                       entry))
    # 4c: one SPA-lin round on the 10k alist code.
    rounds.append(("4c alist10k SPA-lin", make_protocol_spec(
        alist10k, Alg.SPA_APPROX, 100, False, False), "fused_generic", 1024,
        0.025, (1.0, 1.0, 0.0), "fused_generic_spa_lin_decode"))

    out = {}
    for i, (label, spec, kernel, frames, qber, factors, entry) in \
            enumerate(rounds):
        launches, diff, chunk, case = protocol_round(
            torch, card, label, spec, kernel, frames, qber, factors,
            seed=100 + i)
        if entry in out:
            total, worst, first_chunk, first_case = out[entry]
            out[entry] = (total + launches, max(worst, diff), first_chunk,
                          first_case)
        else:
            out[entry] = (launches, diff, chunk, case)
    return out


class SmokeStop(Exception):
    """Raised by phase 4d's progress callback to stop a sweep."""


def phase_checkpoint_resume(torch, card):
    """Phase 4d: the CLI on the card over the 1k QC asset at two QBER
    points (copies of configs/example_qc_layered.json, the fused QC mc
    mode): a run stopped after its first combination by a progress
    callback that raises, then resumed, writes the rows of an
    uninterrupted run (apart from the throughput columns), runs only the
    second combination, and deletes its checkpoint once the CSV lands."""
    from qkd_ldpc_v_tpu_torch import cli
    from qkd_ldpc_v_tpu_torch.ops import fused_qc

    work = REPO / "build" / "chip_smoke_resume"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / QC1K.name).symlink_to(QC1K)
    cfg = json.loads((REPO / "configs" / "example_qc_layered.json").read_text())
    cfg["trials_number"] = RESUME_TRIALS
    cfg["tpu"]["batch_size"] = RESUME_TRIALS
    cfg["code_rate_QBER_ranges"][0]["QBER"] = {"begin": 0.02, "end": 0.03,
                                               "step": 0.01}
    cdir = work / "configs"
    cdir.mkdir()
    (cdir / "run.json").write_text(json.dumps(cfg, indent=2))

    def rows(results):
        _, _, found = read_rows(results)
        return [{k: v for k, v in r.items() if not k.startswith("THROUGHPUT")}
                for r in found]

    fused_qc.reset_counts()
    run_cli(cdir, work / "sparse_matrices", work / "results_full", "cuda")
    full_launches = fused_qc.COUNTS.mc_launches
    want = rows(work / "results_full")
    check(len(want) == 2, f"resume: {len(want)} rows, 2 expected")

    printer = cli._progress_printer

    def stop_after_first(quiet):
        done = [0]

        def cb(inc, total):
            done[0] += inc
            if done[0] > cfg["trials_number"]:
                raise SmokeStop("stopped after the first combination")
        return cb

    results = work / "results_resumed"
    checkpoint = results / ".run.checkpoint.json"
    cli._progress_printer = stop_after_first
    try:
        rc = cli.main(["--configs", str(cdir), "--matrices",
                       str(work / "sparse_matrices"), "--results",
                       str(results), "--device", "cuda", "--quiet"])
    finally:
        cli._progress_printer = printer
    check(rc == 1, f"resume: the stopped run returned {rc}")
    saved = json.loads(checkpoint.read_text())["results"]
    check(len(saved) == 1 and not list(results.glob("*.csv")),
          f"resume: the stopped run left {len(saved)} results")
    fused_qc.reset_counts()
    run_cli(cdir, work / "sparse_matrices", results, "cuda")
    resumed_launches = fused_qc.COUNTS.mc_launches
    got = rows(results)
    print(f"4d resume: uninterrupted run {full_launches} mc launches, resumed "
          f"run {resumed_launches}; rows {got}", flush=True)
    check(2 * resumed_launches == full_launches,
          "resume: the resumed run did not skip the finished combination")
    check(got == want, "resume: the resumed CSV rows differ from the "
          "uninterrupted run's")
    check(not checkpoint.exists(), "resume: the checkpoint was not deleted")
    print(f"4d resume: the resumed CSV rows equal the uninterrupted run's "
          f"apart from the throughput columns (card={card})", flush=True)


def busy_share(events, cats=("kernel", "gpu_memcpy", "gpu_memset")):
    """(busy ms, window ms) of a Chrome trace: the union of the device's
    kernel and copy intervals, and the span of every timed event."""
    timed_events = [e for e in events if "ts" in e and "dur" in e]
    start = min(float(e["ts"]) for e in timed_events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in timed_events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in timed_events
                   if str(e.get("cat", "")).lower() in cats)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, (end - start) / 1e3


def phase_profile(torch, card):
    """Phase 4e: ``--profile`` on cell 1's config
    (configs/example_qc_layered.json over the headline asset) at 4 chunks
    of 16384 frames: the trace must exist and name the fused QC mc kernel;
    prints the share of the traced window, and of the span of its fused QC
    kernels, in which the device is busy."""
    from qkd_ldpc_v_tpu_torch import cli

    work = REPO / "build" / "chip_smoke_profile"
    if work.exists():
        shutil.rmtree(work)
    matrices = work / "sparse_matrices" / "matrices_qc"
    matrices.mkdir(parents=True)
    (matrices / HEADLINE.name).symlink_to(HEADLINE)
    cfg = json.loads((REPO / "configs" / "example_qc_layered.json").read_text())
    cfg["trials_number"] = PROFILE_TRIALS
    cfg["tpu"]["batch_size"] = PROFILE_TRIALS // 4
    cdir = work / "configs"
    cdir.mkdir()
    (cdir / "run.json").write_text(json.dumps(cfg, indent=2))
    t0 = time.perf_counter()
    rc = cli.main(["--configs", str(cdir), "--matrices",
                   str(work / "sparse_matrices"), "--results",
                   str(work / "results"), "--device", "cuda", "--quiet",
                   "--profile", str(work / "profile")])
    wall = time.perf_counter() - t0
    check(rc == 0, f"--profile run returned {rc}")
    trace = work / "profile" / "trace.json"
    check(trace.exists(), f"no trace at {trace}")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    fused = [e for e in kernels if "fused_qc_kernel" in e.get("name", "")]
    check(fused, f"the trace names no fused QC kernel: "
          f"{sorted({e.get('name', '')[:60] for e in kernels})[:8]}")
    busy, window = busy_share(events)
    span0 = min(float(e["ts"]) for e in fused)
    span1 = max(float(e["ts"]) + float(e["dur"]) for e in fused)
    in_loop = [e for e in events if "ts" in e and "dur" in e
               and span0 <= float(e["ts"]) <= span1]
    loop_busy, _ = busy_share(in_loop)
    loop_ms = (span1 - span0) / 1e3
    _, _, rows = read_rows(work / "results")
    print(f"4e profile: {trace.stat().st_size} bytes, {len(events)} events, "
          f"{len(kernels)} kernels ({len(fused)} fused QC, e.g. "
          f"{fused[0]['name'][:80]!r}, {sum(float(e['dur']) for e in fused) / 1e3:.2f} ms); "
          f"device busy {busy:.2f} ms of the {window:.2f} ms traced window "
          f"({busy / window:.1%}; idle {1 - busy / window:.1%}), "
          f"{loop_busy:.2f} ms of the {loop_ms:.2f} ms from the first to "
          f"the last fused QC kernel ({loop_busy / loop_ms:.1%}); whole CLI "
          f"call {wall:.1f} s, FER {rows[0]['FER']} (card={card})",
          flush=True)


def phase_example(torch, card):
    """Phase 4f: examples/qkd_ldpc_example_torch.py --device cuda, in a
    process of its own: the float64 decode on the card must equal the
    oracle's decision and iterations."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "qkd_ldpc_example_torch.py"),
         "--device", "cuda"], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    check(proc.returncode == 0, f"the example failed: {proc.stderr[-2000:]}")
    check("device decode matches the reference-exact trajectory."
          in proc.stdout, "the example did not match the oracle")
    tail = [ln for ln in proc.stdout.splitlines() if ln.startswith(
        ("decision:", "iterations:", "device decode"))]
    print(f"4f example on the card: {tail} (card={card})", flush=True)


# ---------------------------------------------------------------------------
# Distribution (phase 5)
# ---------------------------------------------------------------------------

# Phase 5: two ranks (gloo, both on the one card), the trials and chunk
# frames of each config, the edge-sharded decoder's frames and cap, and the
# seconds the ranks may take.
PHASE5_RANKS = 2
PHASE5_DEVICE = "cuda:0"
PHASE5_TRIALS = {"cell1": (65536, 16384), "cell4": (16384, 16384),
                 "cell5": (4096, 4096), "cell9": (4096, 4096)}
PHASE5_EDGE = {"frames": 256, "qber": 0.025, "alpha": 0.7, "cap": 100}
PHASE5_TIMEOUT_S = 300
THROUGHPUT_COLUMNS = ("THROUGHPUT_MEAN", "THROUGHPUT_STD", "THROUGHPUT_MIN",
                      "THROUGHPUT_MAX")


def parallel_configs(work: Path):
    """Phase 5's config copies, each over a copy of its matrix directory:
    name -> (config path, matrix path, kernel, mode, reduce mode too)."""
    def write(name, cfg, matrix, subdir):
        d = work / name
        matrices = d / "sparse_matrices" / subdir
        matrices.mkdir(parents=True)
        (matrices / matrix.name).symlink_to(matrix)
        untp = matrix.with_suffix(".untp")
        if untp.exists():
            shutil.copy(untp, matrices / untp.name)
        trials, batch = PHASE5_TRIALS[name]
        cfg["trials_number"] = trials
        cfg.setdefault("tpu", {})["batch_size"] = batch
        (d / "run.json").write_text(json.dumps(cfg, indent=2))
        return d / "run.json", matrices / matrix.name

    def load(name):
        return json.loads((REPO / "configs" / name).read_text())

    cell1 = load("example_qc_layered.json")
    cell1["tpu"]["schedule"] = "layered"
    cell4 = load("campaign_fer_1k_alist.json")
    for bracket in cell4["code_rate_QBER_ranges"]:
        if bracket["code_rate"] == 0.78:
            bracket["QBER"] = {"begin": 0.025, "end": 0.025, "step": 0.0028}
    cell5 = load("campaign_fer_sweep_100k.json")
    cell5["tpu"]["schedule"] = "layered"
    for bracket in cell5["code_rate_QBER_ranges"]:
        if bracket["code_rate"] == 0.71:
            bracket["QBER"] = {"begin": 0.03, "end": 0.03, "step": 0.004}
    for amap in cell5["min_sum_normalized_parameters"]["code_rate_alpha_maps"]:
        if amap["code_rate"] == 0.71:
            amap["alpha"] = 0.8
    cell9 = narrowed("campaign_adaptive_aomsa.json", 0.7226, 1, 4096, 1.5)
    return {
        "cell1": (*write("cell1", cell1, HEADLINE, "matrices_qc"),
                  "fused_qc", "mc", True),
        "cell4": (*write("cell4", cell4, ALIST10K, "matrices_alist"),
                  "fused_generic", "mc", True),
        "cell5": (*write("cell5", cell5, FLAGSHIP, "matrices_qc"),
                  "qc_stream", "mc", True),
        "cell9": (*write("cell9", cell9, ALIST10K, "matrices_alist"),
                  "fused_generic", "frame", False),
    }


def edge_case_inputs(torch, matrix, edge, device):
    """The edge-sharded case's inputs on ``device``: (layout, llr [B,N]
    float32, Alice's syndrome [B,M]), keys and errors from a NumPy seed."""
    import numpy as np
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome, log_ratio

    layout = layout_for(matrix)
    rng = np.random.default_rng(5)
    shape = (edge["frames"], matrix.num_bit_nodes)
    alice = torch.from_numpy(rng.integers(0, 2, shape).astype(np.int8))
    flips = torch.from_numpy((rng.random(shape) < edge["qber"])
                             .astype(np.int8))
    alice, bob = alice.to(device), (alice ^ flips).to(device)
    lp = torch.tensor(log_ratio(edge["qber"]), device=device)
    llr = torch.where(bob == 1, -lp, lp)
    return layout, llr, calculate_syndrome(layout, alice)


def kernel_counts():
    """{kernel: (trial/frame/decode launches, mc launches, plain calls on
    the card)} of the four kernels."""
    return {name: (mod.COUNTS.launches, mod.COUNTS.mc_launches,
                   mod.COUNTS.plain_on_cuda)
            for name, mod in kernel_modules().items()}


def phase5_rank(rank, world, address, work, runs, device, edge):
    """One rank of phase 5, in a process of its own (the spawn start
    method): it joins a gloo group through ``initialize_distributed``, runs
    each config through ``qkd_ldpc_batch_simulation`` with
    ``mesh_step_factory`` (gathered, then reduced where asked), the kernel
    counts set to 0 just before each run and read just after, then the
    edge-sharded decoder on ``edge``'s case, and writes its results to
    ``work/rank{rank}.pkl``. It only loads the kernel library the parent
    built."""
    import dataclasses
    import pickle

    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist
    from qkd_ldpc_v_tpu_torch import kernels
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, parse_config_data
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.parallel import (
        edge_sharded_decoder, initialize_distributed, make_data_mesh,
        mesh_step_factory)
    from qkd_ldpc_v_tpu_torch.simulation import (
        prepare_sim_inputs, qkd_ldpc_batch_simulation)

    if torch.device(device).type == "cuda":
        check(kernels.library_path().exists(),
              "the parent did not build the kernel library")
        kernels.library()
    initialize_distributed(address, world, rank, backend="gloo",
                           timeout_s=PHASE5_TIMEOUT_S)
    mesh = make_data_mesh(device)
    out = {"device": str(mesh.device), "world": mesh.world_size}
    for name, (cfg_path, matrix_path, _, _, reduce) in runs.items():
        cfg = parse_config_data(cfg_path)
        sim_inputs = prepare_sim_inputs([matrix_path], cfg)
        for reduce_stats in ((False, True) if reduce else (False,)):
            factory = mesh_step_factory(mesh, reduce_stats=reduce_stats)
            for mod in kernel_modules().values():
                mod.reset_counts()
            results = qkd_ldpc_batch_simulation(sim_inputs, cfg, mesh.device,
                                                step_factory=factory)
            counts = kernel_counts()
            step = factory(sim_inputs[0].matrix, cfg, cfg.batch_size)
            # The first call warms up (throughput measurement is on).
            out[name, reduce_stats] = (
                [dataclasses.asdict(r) for r in results], counts,
                step.times[1:])
    matrix = read_sparse_matrix_alist(ALIST10K)
    layout, llr, syndrome = edge_case_inputs(torch, matrix, edge, mesh.device)
    decode = edge_sharded_decoder(layout, DecodingAlgorithm.NMSA, edge["cap"],
                                  mesh)
    t0 = time.perf_counter()
    res = [t.cpu() for t in decode(llr, syndrome, edge["alpha"])]
    out["edge"] = (res, (time.perf_counter() - t0) * 1e3)
    with open(Path(work) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(work: Path, runs, device):
    """Spawn phase 5's ranks and wait for them; every rank still running at
    the time limit is killed. Returns each rank's results."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=phase5_rank,
                         args=(rank, PHASE5_RANKS, address, str(work), runs,
                               device, PHASE5_EDGE))
             for rank in range(PHASE5_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PHASE5_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * PHASE5_RANKS, f"phase 5: ranks exited with {codes}")
    out = []
    for rank in range(PHASE5_RANKS):
        with open(work / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def csv_rows(results, cfg, directory: Path):
    """The CSV rows ``write_file`` writes for ``results`` (dicts of
    ``SimResult`` fields), without the throughput columns."""
    from qkd_ldpc_v_tpu_torch.simulation import (
        ScalingFactors, SimResult, write_file)

    objs = []
    for d in results:
        d = dict(d)
        sf = d.pop("scaling_factors")
        objs.append(SimResult(**d, scaling_factors=ScalingFactors(**sf)))
    write_file(objs, cfg, "00h-00m-00s", directory)
    return strip_throughput(read_rows(directory)[2])


def strip_throughput(rows):
    return [{k: v for k, v in row.items() if k not in THROUGHPUT_COLUMNS}
            for row in rows]


def frames_per_s(result, out_len, cfg):
    """Decoded frames/s of a result's chunk timers (its throughput counts
    ``out_len`` output key bits a frame), RTT removed."""
    rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
    return 1e6 / (out_len * 1e6 / result["throughput_mean"] - rtt_us)


def check_rank_counts(label, counts, kernel, mode):
    """A run (a rank's, or a campaign point's) launched ``kernel``'s
    ``mode`` ("mc", or "frame" or "trial" among the other modes), no other
    kernel or mode, and no plain version on the card. Returns the
    launches."""
    launched = counts[kernel][1 if mode == "mc" else 0]
    check(launched > 0, f"{label}: {kernel} {mode} did not launch")
    others = (sum(sum(c[:2]) for k, c in counts.items() if k != kernel)
              + counts[kernel][0 if mode == "mc" else 1])
    check(others == 0, f"{label}: another kernel or mode launched")
    check(all(c[2] == 0 for c in counts.values()),
          f"{label}: a plain version ran on the card")
    return launched


def phase_parallel(torch, card):
    """Phase 5: the main paths split over two ranks (see the module
    docstring). The single-rank references run in this process before the
    ranks start: phase 3's CSV rows for cell 1, a run of each one-chunk
    config, cell 9 fed the ranks' draws in rank order, and the generic
    torch decoder for the edge-sharded case."""
    import dataclasses
    import math

    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, parse_config_data
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.ops.decoders import make_decoder
    from qkd_ldpc_v_tpu_torch.simulation import (
        default_key_source, prepare_sim_inputs, qkd_ldpc_batch_simulation)

    work = REPO / "build" / "chip_smoke_parallel"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    runs = parallel_configs(work)
    dev = torch.device(PHASE5_DEVICE)
    cfgs = {name: parse_config_data(run[0]) for name, run in runs.items()}
    sims = {name: prepare_sim_inputs([run[1]], cfgs[name])
            for name, run in runs.items()}
    out_lens = {}
    for name, sim_inputs in sims.items():
        cfg, comb = cfgs[name], sim_inputs[0].combinations[0]
        check(len(sim_inputs[0].combinations) == 1,
              f"phase 5 {name}: one combination expected")
        removed = (len(comb.matrix_params.bits_to_remove)
                   if cfg.enable_code_rate_adaptation
                   or cfg.enable_privacy_maintenance else 0)
        out_lens[name] = sim_inputs[0].matrix.num_bit_nodes - removed

    # Single-rank references.
    phase3 = read_rows(REPO / "build" / "chip_smoke" / "results_layered")[2]
    ref_rows = {"cell1": strip_throughput(phase3)}
    ref_results = {"cell1": [{"throughput_mean":
                              float(phase3[0]["THROUGHPUT_MEAN"])}]}
    for name in ("cell4", "cell5", "cell9"):
        cfg = cfgs[name]
        source = None
        if name == "cell9":
            local = math.ceil(cfg.batch_size / PHASE5_RANKS)
            sources = [default_key_source(cfg.simulation_seed, dev, rank)
                       for rank in range(PHASE5_RANKS)]

            def source(sim_number, chunk, batch, n, _s=sources, _l=local,
                       **kw):
                draws = [s(sim_number, chunk, _l, n, **kw) for s in _s]
                return tuple(torch.cat(p)[:batch] for p in zip(*draws))

        results = qkd_ldpc_batch_simulation(sims[name], cfg, dev,
                                            key_source=source)
        ref_results[name] = [dataclasses.asdict(r) for r in results]
        ref_rows[name] = csv_rows(ref_results[name], cfg,
                                  work / f"single_{name}")
    matrix = read_sparse_matrix_alist(ALIST10K)
    layout, llr, syndrome = edge_case_inputs(torch, matrix, PHASE5_EDGE, dev)
    plain = make_decoder(layout, DecodingAlgorithm.NMSA, PHASE5_EDGE["cap"],
                         False)
    t0 = time.perf_counter()
    want_edge = [t.cpu() for t in plain(llr, syndrome, PHASE5_EDGE["alpha"])]
    plain_ms = (time.perf_counter() - t0) * 1e3
    del llr, syndrome
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(work, runs, PHASE5_DEVICE)
    print(f"phase 5: {PHASE5_RANKS} ranks (gloo, spawn) on "
          f"{[r['device'] for r in ranks]} ran in "
          f"{time.perf_counter() - t0:.1f} s (card={card})", flush=True)

    for name, (_, _, kernel, mode, reduce) in runs.items():
        cfg = cfgs[name]
        for rank, out in enumerate(ranks):
            for reduce_stats in ((False, True) if reduce else (False,)):
                label = (f"phase 5 {name} {'reduced' if reduce_stats else 'gathered'}"
                         f" rank {rank}")
                results, counts, times = out[name, reduce_stats]
                launched = check_rank_counts(label, counts, kernel, mode)
                decode_ms = sum(t[0] for t in times) * 1e3 / len(times)
                coll_ms = sum(t[1] for t in times) * 1e3 / len(times)
                frames = cfg.trials_number / sum(sum(t) for t in times)
                print(f"{label}: {kernel} {mode} launches={launched}, "
                      f"{len(times)} chunks of {cfg.batch_size} frames "
                      f"({math.ceil(cfg.batch_size / PHASE5_RANKS)} a rank): "
                      f"decode {decode_ms:.2f} ms + collective {coll_ms:.2f} "
                      f"ms a chunk; {frames:.0f} frames/s on {PHASE5_RANKS} "
                      f"ranks (card={card})", flush=True)
                if not reduce_stats:
                    rows = csv_rows(results, cfg,
                                    work / f"rank{rank}_{name}")
                    check(rows == ref_rows[name],
                          f"{label}: CSV rows differ from the single-rank "
                          f"run's:\n{rows}\n{ref_rows[name]}")
                    continue
                gathered = out[name, False][0]
                for got, want in zip(results, gathered):
                    for key in ("ratio_trials_success_decoding",
                                "ratio_trials_success_ldpc",
                                "iter_success_min", "iter_success_max"):
                        check(got[key] == want[key], f"{label}: {key}")
                    for key in ("iter_success_mean", "iter_success_std"):
                        check(abs(got[key] - want[key])
                              <= 1e-12 * abs(want[key]), f"{label}: {key}")
        two = frames_per_s(ranks[0][name, False][0][0], out_lens[name], cfg)
        one = frames_per_s(ref_results[name][0], out_lens[name], cfg)
        against = "phase 3" if name == "cell1" else "phase 5's single rank"
        print(f"phase 5 {name}: chunk-timer frames/s, {PHASE5_RANKS} ranks "
              f"{two:.0f} against 1 rank {one:.0f} ({against}); rank 0's rows "
              f"equal {against}'s apart from throughput (card={card})",
              flush=True)

    for rank, out in enumerate(ranks):
        got, ms = out["edge"]
        for g, w in zip(got, want_edge):
            check(torch.equal(g, w), f"phase 5 edge rank {rank}: the "
                  "edge-sharded decoder differs from the generic decoder")
        print(f"phase 5 edge rank {rank}: edge-sharded NMSA on the 10k alist "
              f"code, {PHASE5_EDGE['frames']} frames, mean iterations "
              f"{got[2].float().mean().item():.2f}: {ms:.1f} ms against the "
              f"generic torch decoder's {plain_ms:.1f} ms on one rank; "
              f"decisions and iterations equal (card={card})", flush=True)


CAMPAIGN_TRIALS = 4096
TUNE_TRIALS = 8192
# The kernel and mode each campaign code's points must launch.
CAMPAIGN_KERNELS = {
    "alist 1k R=0.72 CW=4 (committed)": ("fused_generic", "mc"),
    "alist 1k R=0.62 CW=3 (committed)": ("fused_generic", "mc"),
    "QC-PEG R=0.70 Z=512 CW=4 (headline)": ("fused_qc", "mc"),
    "QC-PEG R=0.725 Z=256 CW=4": ("fused_qc", "mc"),
    "QC 100k R=0.70 Z=2048 CW=3 (streamed QC)": ("qc_stream", "mc"),
    "QC 100k R=0.84 Z=2048 CW=3 (streamed QC)": ("qc_stream", "mc"),
    "QC 100k R=0.50 Z=2048 CW=3 (streamed QC)": ("qc_stream", "mc"),
    "alist 100k R=0.69 CW=3 (streaming)": ("generic_stream", "trial"),
}
CAMPAIGN_POINTS = 40
MIN_CONVERGED = 200
# The campaign's codes that no phase-2 case decodes: (QBER in the
# waterfall, where some frames converge and some fail; frames) of each one's
# exact check against the plain version.
CAMPAIGN_EXACT = {
    "alist 1k R=0.72 CW=4 (committed)": (0.03, MC_FRAMES),
    "alist 1k R=0.62 CW=3 (committed)": (0.05, MC_FRAMES),
    "QC-PEG R=0.725 Z=256 CW=4": (0.0315, MC_FRAMES),
    "QC 100k R=0.84 Z=2048 CW=3 (streamed QC)": (0.014, 128),
    "QC 100k R=0.50 Z=2048 CW=3 (streamed QC)": (0.0825, 128),
}


def load_script(name, folder="scripts"):
    """{folder}/{name}.py as a module (scripts/ and tests/ are not
    packages)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def counted_points(rows, label, expected):
    """Run a generator of campaign points one ``next`` at a time, the kernel
    counts set to 0 just before each point and read just after; each point
    must launch ``expected(row)``'s (kernel, mode) alone, with no plain
    version on the card. Yields (row, launches)."""
    mods = kernel_modules().values()
    while True:
        for mod in mods:
            mod.reset_counts()
        row = next(rows, None)
        if row is None:
            return
        kernel, mode = expected(row)
        yield row, check_rank_counts(label(row), kernel_counts(), kernel, mode)


def campaign_code_vs_plain(torch, card, fc, code, index):
    """One campaign code's mode, built by ``simulation`` from the campaign's
    Config as its points build it, against its plain version on the card at
    ``CAMPAIGN_EXACT``'s QBER and frames: conv, keys and iterations equal."""
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        chunk_seed, exact_error_count, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import (
        montecarlo_trial, select_engine)

    qber, frames = CAMPAIGN_EXACT[code.name]
    cfg = fc.point_config(qber, frames, frames)
    mc = montecarlo_trial(select_engine(code.matrix, cfg), code.matrix, cfg)
    n = code.matrix.num_bit_nodes
    ne = exact_error_count(n, qber)
    args = (chunk_seed(fc.SEED, 0, index), MC_FRAME0, frames, ne,
            log_ratio(ne / n), code.alpha, 0.0, 0.0)
    label = f"phase 6a exact {code.name} q={qber}"
    for mod in kernel_modules().values():
        mod.reset_counts()
    got = mc(*args, device="cuda")
    check_rank_counts(label, kernel_counts(), *CAMPAIGN_KERNELS[code.name])
    # The plain version's first call, its tables' copy to the card included.
    want, plain_ms = timed(lambda: mc.plain(*args, device="cuda"), torch)
    diff = max_abs_diff(tuple(got), tuple(want), torch)
    n_fail = int((~got[0]).sum().item())
    print(f"{label}: {CAMPAIGN_KERNELS[code.name][0]} mc frames {MC_FRAME0}-"
          f"{MC_FRAME0 + frames - 1}: unconverged={n_fail}/{frames} mean "
          f"iterations {got[2].float().mean().item():.2f} plain_ms="
          f"{plain_ms:.1f} max_abs_err={diff} (card={card})", flush=True)
    check(diff == 0, f"{label}: the mc kernel != plain")
    check(0 < n_fail < frames, f"{label}: not in the waterfall")


def phase_campaigns(torch, card):
    """Phase 6: the campaign entry points (see the module docstring)."""
    import collections

    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    fc = load_script("fer_campaign_torch")
    tf = load_script("tune_factors_torch")
    launches = collections.Counter()
    failed = []
    compared = exact = 0
    for suite in ("1k", "10k", "100k"):
        t0 = time.perf_counter()
        codes = fc.suite_codes(suite, REPO)
        read_s = time.perf_counter() - t0
        want = fc.jax_rows(suite, REPO)
        rows = []
        t0 = time.perf_counter()
        points = counted_points(
            fc.campaign_rows(codes, CAMPAIGN_TRIALS, "cuda"),
            lambda r: f"phase 6a {r.name} q={r.qber}",
            lambda r: CAMPAIGN_KERNELS[r.name])
        for row, n in points:
            kernel, mode = CAMPAIGN_KERNELS[row.name]
            launches[kernel, mode] += n
            if kernel == "generic_stream":
                # Every streamed trial of the point on the cluster kernel.
                counts = generic_stream.counts()
                check(counts[2] == counts[0] and counts[3] >= CAMPAIGN_TRIALS,
                      f"phase 6a {row.name} q={row.qber}: not every trial "
                      f"took the cluster kernel: {counts}")
            rows.append(row)
            key = (row.name, row.qber)
            check(key in want, f"phase 6a: {key} is in no table of "
                  f"{fc.JAX_TABLES[suite]}")
            alpha, fer, iters = want[key]
            check(alpha == row.alpha, f"phase 6a {key}: alpha {row.alpha} "
                  f"against the table's {alpha}")
            res = row.result
            fer_m = fc.fer_margin(row.fer, fer, CAMPAIGN_TRIALS)
            ok = abs(row.fer - fer) <= fer_m
            conv = round(res.ratio_trials_success_decoding * CAMPAIGN_TRIALS)
            conv_j = round((1 - fer) * CAMPAIGN_TRIALS)
            it_text = "iterations not compared"
            if min(conv, conv_j) >= MIN_CONVERGED:
                it_m = fc.iters_margin(res.iter_success_std, conv, conv_j)
                it_ok = abs(res.iter_success_mean - iters) <= it_m
                ok = ok and it_ok
                it_text = (f"|diff| {abs(res.iter_success_mean - iters):.3f} "
                           f"margin {it_m:.3f}")
            compared += 1
            if not ok:
                failed.append(key)
            print(f"phase 6a {row.name} q={row.qber}: FER port {row.fer:.5f} "
                  f"JAX {fer:.5f} (|diff| {abs(row.fer - fer):.5f} margin "
                  f"{fer_m:.5f}); mean iterations port "
                  f"{res.iter_success_mean:.2f} (std {res.iter_success_std:.2f},"
                  f" {conv} converged) JAX {iters:.1f}: {it_text}; "
                  f"{kernel} {mode} launches={n}; {row.seconds:.3f} s "
                  f"{'ok' if ok else 'DISAGREES'} (card={card})", flush=True)
        print(f"phase 6a suite {suite}: {len(rows)} points in "
              f"{time.perf_counter() - t0:.2f} s, matrices built or read in "
              f"{read_s:.2f} s (card={card})", flush=True)
        for code in codes:
            if code.name in CAMPAIGN_EXACT:
                campaign_code_vs_plain(torch, card, fc, code, exact)
                exact += 1
            if CAMPAIGN_KERNELS[code.name][0] == "generic_stream":
                # One chunk of the campaign's mid point, its keys as the
                # campaign draws them, on the cluster kernel.
                dev = torch.device("cuda")
                n = code.matrix.num_bit_nodes
                ne = exact_error_count(n, 0.03)
                alice, bits = default_key_source(fc.SEED, dev)(
                    0, 0, fc.ALIST_100K_BATCH, n)
                bob = inject_errors(bits, alice, ne, wide=True)
                del bits
                algorithm = DecodingAlgorithm.NMSA
                cluster_route(
                    torch, card, f"phase 6a {code.name} q=0.03", code.matrix,
                    generic_stream.make_generic_stream_trial(
                        code.matrix, algorithm, fc.CAP, False),
                    alice, bob, (log_ratio(ne / n), code.alpha, 0.0, 0.0),
                    fused_generic.generic_flags(algorithm))
    check(compared == CAMPAIGN_POINTS,
          f"phase 6a: {compared} points compared, not {CAMPAIGN_POINTS}")
    check(exact == len(CAMPAIGN_EXACT),
          f"phase 6a: {exact} codes checked exactly, not {len(CAMPAIGN_EXACT)}")
    check(not failed, f"phase 6a: points disagree with the JAX tables: {failed}")
    print(f"phase 6a: {compared} points within the rule, {exact} codes "
          f"exactly equal to the plain version; launches: "
          + ", ".join(f"{k} {m} {n}" for (k, m), n in launches.items())
          + f" (card={card})", flush=True)

    matrix = tf.headline_code()
    rows = []
    t0 = time.perf_counter()
    for row, n in counted_points(
            tf.tune_rows(matrix, list(tf.GRIDS), TUNE_TRIALS, 0.03, "cuda"),
            lambda r: f"phase 6b {r.alg} {r.primary}/{r.secondary}",
            lambda r: ("fused_qc", "mc")):
        rows.append(row)
        print(f"phase 6b {row.line()} fused_qc mc launches={n} "
              f"{row.seconds:.3f} s", flush=True)
    check(len(rows) == sum(len(g) for g in tf.GRIDS.values()),
          "phase 6b: a point is missing")
    for name, row in tf.best(rows).items():
        print(f"phase 6b best {name}: primary={row.primary} "
              f"secondary={row.secondary} FER={row.fer:.5f} mean iterations "
              f"{row.result.iter_success_mean:.2f}", flush=True)
    print(f"phase 6b: {len(rows)} points, {TUNE_TRIALS} trials each, in "
          f"{time.perf_counter() - t0:.2f} s (card={card})", flush=True)

    read_s, greedy_s, pos = load_script("time_host_readers").port_host_times(
        ALIST100K, 2067)
    cached = ALIST100K.with_suffix(".untp").read_text()
    check(" ".join(str(int(p)) for p in pos) + " " == cached,
          "phase 6c: the greedy differs from the committed .untp")
    print(f"phase 6c: 100k alist read {read_s:.2f} s, untainted greedy "
          f"{greedy_s:.2f} s ({len(pos)} positions, equal to the committed "
          f".untp) on the card host's CPU", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "qkd_ldpc_v_tpu_torch").is_dir():
        print(f"chip_smoke: no qkd_ldpc_v_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from qkd_ldpc_v_tpu_torch import kernels

    start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {kernels.build_seconds:.1f} s): {kernels.library_path().name}",
          flush=True)
    for line in ptxas_lines(kernels.build_log):
        print(line)

    def elapsed(phase):
        print(f"phase {phase} done at {time.perf_counter() - start:.1f} s",
              flush=True)

    worst2, headline_times = phase_kernel_vs_plain(torch, card)
    elapsed("2")
    worst2b, generic_times = phase_generic_vs_plain(torch, card)
    elapsed("2b")
    worst2c, stream_times = phase_stream_vs_plain(torch, card)
    elapsed("2c")
    worst2d, generic_stream_times = phase_generic_stream_vs_plain(torch, card)
    elapsed("2d")
    worst2e, frame_times = phase_frame_vs_plain(torch, card)
    elapsed("2e")
    worst2f, mc_times = phase_mc_vs_plain(torch, card)
    elapsed("2f")
    phase_spa_steps(torch, card)
    worst2g, spa_times = phase_spa_vs_plain(torch, card)
    elapsed("2g")
    inject2h = phase_inject_vs_plain(torch, card)
    elapsed("2h")
    main3 = phase_main_path(torch, card)
    elapsed("3")
    main3b = phase_generic_main_path(torch, card)
    elapsed("3b")
    main3c = phase_stream_main_path(torch, card)
    elapsed("3c")
    phase_cli_cpu_vs_card(torch, card)
    elapsed("3f")
    generic_stream_launches, worst3d, chunk3d = phase_generic_stream_main_path(
        torch, card)
    elapsed("3d")
    ra = phase_rate_adaptive_main_path(torch, card)
    elapsed("3e")
    spa3g = phase_spa_main_path(torch, card)
    elapsed("3g")
    protocol4 = phase_protocol(torch, card)
    elapsed("4a-4c")
    phase_checkpoint_resume(torch, card)
    elapsed("4d")
    phase_profile(torch, card)
    elapsed("4e")
    phase_example(torch, card)
    elapsed("4f")
    phase_parallel(torch, card)
    elapsed("5")
    phase_campaigns(torch, card)
    elapsed("6")
    check("jax" not in sys.modules, "jax was imported")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s "
          f"({card})", flush=True)

    def entry(name, source, replaces, launches, worst, chunk, case):
        # ms and bound_ms: one main-path chunk (phase 3, 3b, 3c, 3d or 3e;
        # layered where the kernel has it), at the fill the main path runs
        # at. plain_ms: the plain version on the phase-2 timed case.
        ms, bound_ms, bound_by, frames = chunk
        plain_ms, plain_frames = case
        return {"name": name, "route": "cuda",
                "source": f"qkd_ldpc_v_tpu_torch/csrc/{source}",
                "replaces": f"qkd_ldpc_v_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": worst, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, "frames": frames,
                "plain_frames": plain_frames}

    def trial_entry(name, source, replaces, worst2x, main, case):
        launches, worst, chunk = main["trial"]
        return entry(name, source, replaces, launches, max(worst2x, worst),
                     chunk, case)

    def spa_entry(name, source, replaces, kernel, run):
        # The SPA pair: the main path of phase 3g and phase 2g's cases.
        launches, worst, chunk = spa3g[run]
        return entry(name, source, replaces, launches,
                     max(worst2g[kernel], worst), chunk, spa_times[name])

    def protocol_entry(name, source, replaces, worst2x):
        # The library rounds of phase 4a-4c: launches summed over them, ms
        # and bound_ms of the first round's decode, plain_ms the plain
        # decode of the same round.
        launches, worst, chunk, case = protocol4[name]
        return entry(name, source, replaces, launches, max(worst2x, worst),
                     chunk, case)

    def mc_entry(name, source, replaces, main):
        launches, worst, chunk = main["mc"]
        return entry(name, source, replaces, launches,
                     max(worst2f[name], worst), chunk, mc_times[name])

    print(json.dumps({"kernels": [
        trial_entry("fused_qc", "fused_qc.cu", "pallas_qc.py:249", worst2,
                    main3, headline_times),
        trial_entry("fused_generic", "fused_generic.cu",
                    "pallas_generic.py:395", worst2b, main3b, generic_times),
        trial_entry("qc_stream", "qc_stream.cu", "pallas_qc_stream.py:207",
                    worst2c, main3c, stream_times),
        entry("generic_stream", "generic_stream.cu",
              "pallas_stream.py:303,434,524,589", generic_stream_launches,
              max(worst2d, worst3d), chunk3d, generic_stream_times),
        entry("fused_qc_frame", "fused_qc.cu", "pallas_qc.py:869",
              ra["fused_qc"][0], max(worst2e["fused_qc"], ra["fused_qc"][1]),
              ra["fused_qc"][2], frame_times["fused_qc"]),
        entry("fused_generic_frame", "fused_generic.cu",
              "pallas_generic.py:1122", ra["fused_generic"][0],
              max(worst2e["fused_generic"], ra["fused_generic"][1]),
              ra["fused_generic"][2], frame_times["fused_generic"]),
        mc_entry("fused_qc_mc", "fused_qc.cu", "pallas_qc.py:801", main3),
        mc_entry("qc_stream_mc", "qc_stream.cu", "pallas_qc_stream.py:811",
                 main3c),
        mc_entry("fused_generic_mc", "fused_generic.cu",
                 "pallas_generic.py:1179", main3b),
        spa_entry("fused_qc_spa_mc", "fused_qc.cu", "pallas_qc.py:388",
                  "fused_qc", "spa_headline"),
        spa_entry("fused_qc_spa_frame", "fused_qc.cu", "pallas_qc.py:388",
                  "fused_qc", "spa_fec_headline"),
        spa_entry("qc_stream_spa_mc", "qc_stream.cu", "pallas_qc_stream.py:454",
                  "qc_stream", "spa_flagship"),
        spa_entry("fused_generic_spa_lin_mc", "fused_generic.cu",
                  "pallas_generic.py:665", "fused_generic",
                  "spa_lin_alist10k"),
        spa_entry("generic_stream_spa", "generic_stream.cu",
                  "pallas_stream.py:348", "generic_stream", "spa_alist100k"),
        protocol_entry("fused_generic_decode", "fused_generic.cu",
                       "pallas_generic.py:998", worst2b),
        protocol_entry("generic_stream_decode", "generic_stream.cu",
                       "pallas_stream.py:1010", worst2d),
        protocol_entry("fused_generic_spa_lin_decode", "fused_generic.cu",
                       "pallas_generic.py:665", worst2g["fused_generic"]),
        entry("inject_select", "inject.cu", "channel.py:39 (XLA, no Pallas)",
              *inject2h),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
