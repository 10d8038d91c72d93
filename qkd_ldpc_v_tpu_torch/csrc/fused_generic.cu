// Fused generic LDPC decoder for Hopper (sm_90a): one thread block decodes
// one frame at a time of an arbitrary sparse parity-check matrix, from raw
// keys (trial mode), from LLRs and a syndrome (decode mode), from a
// rate-adapted frame and its LLRs (frame mode) or from keys it draws itself
// (mc mode) to its per-frame statistics or decisions.
//
// Replaces the TPU kernel qkd_ldpc_v_tpu/ops/pallas_generic.py::_build.kernel
// (trial, decode, frame and mc modes; the min-sum family
// NMSA/OMSA/ANMSA/AOMSA and the SPA pair SPA / SPA-lin-approx, whose check
// update is csrc/spa.cuh; the flooding schedule). The plain torch version
// it is held to, bit for bit, is qkd_ldpc_v_tpu_torch/ops/decoders.py::
// make_decoder in float32 (wrapped by ops/fused_generic.py), and for the mc
// mode's keys ops/channel.py::mc_channel. The mc mode draws each bit's keys
// at its external position, not at the TPU kernel's flat, lane-padded plane
// position. None of the TPU kernel's transport carries over: no Clos
// regroup, no 128-lane planes, no bf16x2 packing and no decision bit in the
// mantissa, which is why this kernel is exact where the TPU kernel is only
// statistically equal to the reference decoder.
//
// Edges are addressed through index tables built on the host from
// models/layout.py::EdgeLayout in its internal (degree-sorted) node order
// (ops/fused_generic.py::fused_tables): each check's edge bits (padded
// with kRun entries, so that a register run may read past the last check)
// and each bit's (check, slot) words, each node's Row (offset, stride,
// degree) into them, and the maps between internal and external bit and
// check indices. Min-sum's are node-major (a check's bits neighbours, so a
// run's loads take immediate offsets); the SPA pair's are slot-major within
// each degree group (slot k of the group's j-th node at offset + k * count
// + j, so that a warp's neighbouring nodes read neighbouring words). They
// stay in global memory, one copy read by every block through L1 and L2.
//
// Design (ops/fused_generic.py::launch_plan mirrors the layout).
//   * Launch shape: one block per frame (a persistent grid of as many
//     blocks as fit at once where the checks live in global memory). Per
//     frame, in shared memory: the f32 bit totals (N), the checks, the
//     syndrome bits and Alice's and Bob's key bits, packed 32 to a word
//     (trial, frame, mc). Decisions are read from the totals (total <= 0
//     -> 1); there is no LLR plane and no decision plane.
//   * Min-sum check->bit values are stored compressed per check, in the
//     form of the QC kernels: a clamped value pair (p1, p2) and W =
//     ceil(2 * max check degree / 32) word planes of two bits per edge (m >
//     0, |m| == min1); an edge with m <= 0 takes -p, the exact negation
//     (every bit set where the clamp's threshold is negative, which maps
//     every value to the threshold). 12 bytes per check of degree <= 16 in
//     place of 4 per edge. Its second minimum follows the generic decoder's
//     tie rule, not the QC kernels': where every |m| of a check of two or
//     more edges is inf, min2 is inf. Each frame starts from stored checks
//     whose values rebuild as +0. The SPA pair keeps f32 check->bit values
//     by slot ([max degree][M]). Either sits in shared memory where a
//     frame's fit, else in a per-block global slice.
//   * The check pass: each thread owns a check (internal order, so a warp's
//     checks mostly share one degree). A check of at most kRun edges runs
//     branch-free over a register run of 6, 8, ..., 16 slots, the shortest
//     that holds it: all its totals are loaded before any is used, and
//     slots past its degree read a real total and take the message +inf,
//     which moves no minimum, sign or parity. Longer checks make two passes.
//     Each message is formed on read as clamp(t - v) from the total and the
//     stored value (the first sweep's channel messages unclamped, through
//     +-inf clamp bounds). The same pass takes the check's parity over the
//     decisions it reads: the adaptive pair's factor comes from it, and it
//     is the convergence test of the sweep before (the adaptive pair: of
//     the decisions before this sweep), so a frame whose checks all hold
//     stops with that pass's values dropped. One parity-only pass follows
//     the last sweep. Two barriers an iteration.
//   * The bit pass, by bit ownership: each thread forms the totals of its
//     bits as ((llr + v_0) + v_1) + ... over the bit's edges in slot order
//     (ascending check index; the plain decoder's llr-first association),
//     rebuilding each v from its stored check through the bit-major
//     (check, slot) table. Trial and mc modes form the LLR from Bob's packed
//     bit; decode and frame modes read it again from global memory.
//   * mc: one Philox call serves the four external positions of its
//     counter; Alice's bits (packed in external order) and the sort keys
//     (in the totals' space) are drawn once, the selection state sits in
//     the checks' space, the exact selection is the warp's bucket walk
//     (philox.cuh::kth_smallest_scan), and Alice's and Bob's bits are then
//     packed in internal order through bit_ext; Alice's stay packed to the
//     key compare.
//   * Exactness: -fmad=false, no fast math and no flush-to-zero; min.NaN /
//     max.NaN (rate-adapted LLRs carry the float32 maximum on shortened
//     bits, so sums can overflow to inf and inf - inf gives NaN, which
//     torch.minimum / torch.maximum keep); a per-frame exit with the
//     decisions of that moment, which equals the plain decoder's frozen
//     decisions.
//
// What bounds it on this card (the 10k alist code, 16384 mc frames;
// scripts/probe_fused_generic.py and scripts/variants_fused_generic.py,
// PERF.md section 6): a min-sum frame takes 78 KB of shared memory, so two
// blocks of 512 threads share an SM, at 60-64 registers and no spill; one
// block per SM made the chunk 39 % slower, 1024 threads 11 % and 256
// threads 17 %. A sweep of every frame takes 2.21 ms and the staging 1.80
// ms, so what holds it is the check update's instruction issue and the
// tables' loads through L1: every check in the 16-slot run cost 7 %, and
// 16-bit tables (where a code's check index and slot fit 16 bits) saved
// 8 %. Checks in the global slice cost 34 % (min-sum). The SPA pair's
// values (214 KB a frame) leave one block per SM, which runs best at 1024
// threads (2.7 times as fast as at 256), and its instantiations spill 0-100
// bytes (mc in shared memory: 12 SPA-lin, 40 SPA).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "spa.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
// Checks of at most kRun edges (one word of edge bits) keep their totals in
// registers, all loads in flight at once, in a register run of 6, 8, ...,
// kRun slots (with_run: the shortest that holds them); longer ones take
// two passes.
constexpr int kRun = 16;
template <int R>
struct Run {
  static constexpr int value = R;
};

template <typename F>
__device__ __forceinline__ int with_run(int deg, F&& f) {
  if (deg <= 6) return f(Run<6>{});
  if (deg <= 8) return f(Run<8>{});
  if (deg <= 10) return f(Run<10>{});
  if (deg <= 12) return f(Run<12>{});
  if (deg <= 14) return f(Run<14>{});
  return f(Run<kRun>{});
}

// A bit's stored values are loaded kBitRun at a time before any is added.
constexpr int kBitRun = 4;
// Launch flag: the checks in a per-block global slice.
constexpr int kSlice = 16;

enum Mode { kDecode = 0, kTrial = 1, kFrame = 2, kMc = 3 };

struct Params {
  const int8_t* alice;    // trial, frame: [B, N] 0/1, external order
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr;       // decode, frame: [B, N]
  const int8_t* syn;      // decode: [B, M] 0/1
  const int32_t* table;   // see ops/fused_generic.py::fused_tables
  float* slice;           // kSlice: [grid][slice_floats]
  int n, m, e, max_deg, batch, max_iter, use_threshold, mode;
  float log_p, primary, secondary, threshold;
  int8_t* dec_out;        // decode: [B, N]
  int8_t* conv;           // [B]
  int8_t* keys;           // trial, frame, mc: [B]
  int32_t* iters;         // [B]
};

// f32 min and max that return NaN where either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Clamp bounds: the message clamp [-threshold, threshold] where it applies,
// else [-inf, inf], which min.NaN / max.NaN pass every value through
// unchanged (NaN and -0 included), so that no launch branches on it.
struct Bounds {
  float lo, hi;
};

__device__ __forceinline__ float clamp_to(float x, Bounds b) {
  return min_nan(max_nan(x, b.lo), b.hi);
}

__device__ __forceinline__ Bounds bounds(bool on, const Params& p) {
  return on ? Bounds{-p.threshold, p.threshold} : Bounds{-INFINITY, INFINITY};
}

// The min-sum check->bit value (unclamped) of an edge with m > 0 (excl =
// 1): eabs = |m| == min1 ? min2 : min1 (plain: ops/decoders.py::
// _minsum_values).
template <bool OFFSET>
__device__ __forceinline__ float minsum_from(float eabs, float row_sign,
                                             float f) {
  if (OFFSET) return row_sign * 1.f * max_nan(eabs - f, 0.f);
  return f * row_sign * 1.f * eabs;
}

// ---------------------------------------------------------------------------
// Layout (mirrored by ops/fused_generic.py::launch_plan).
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline size_t words_of(size_t bits) {
  return (bits + 31) / 32;
}

// Words of one compressed check: two bits per edge.
__host__ __device__ inline int check_words(int max_deg) {
  return (2 * max_deg + 31) / 32;
}

// Floats of one frame's checks: min-sum the value pairs (2 M) and the word
// planes (W M); the SPA pair one value per slot ([max_deg][M]).
__host__ __device__ inline size_t check_floats(int m, int max_deg,
                                               int check) {
  if (check == kMinSum) return (2 + (size_t)check_words(max_deg)) * m;
  return (size_t)max_deg * m;
}

// Floats of one block's global slice: a frame's checks, rounded up to 16
// bytes so that every slice's value pairs are aligned.
__host__ __device__ inline size_t slice_floats(int m, int max_deg,
                                               int check) {
  return (check_floats(m, max_deg, check) + 3) / 4 * 4;
}

// Byte offsets of one block's shared memory: the f32 totals (mc staging:
// the sort keys), the checks (unless kSlice; mc staging: the selection
// state, then Alice's bits in external order), the syndrome bits, Alice's
// bits (all modes but decode) and Bob's (trial, mc), packed in internal
// order.
struct SharedLayout {
  size_t msgs, alice_ext, syn, alice, bob, bytes;
};

__host__ __device__ inline SharedLayout shared_layout(int n, int m,
                                                      int max_deg, int check,
                                                      bool slice, int mode) {
  SharedLayout s;
  const size_t bits = 4 * words_of(n);
  s.msgs = align16(4 * (size_t)n);
  s.alice_ext = s.msgs + align16(sizeof(Selection));
  size_t msgs = slice ? 0 : 4 * check_floats(m, max_deg, check);
  if (mode == kMc && msgs < s.alice_ext - s.msgs + bits)
    msgs = s.alice_ext - s.msgs + bits;
  s.syn = align16(s.msgs + msgs);
  s.alice = s.syn + 4 * words_of(m);
  s.bob = s.alice + (mode == kDecode ? 0 : bits);
  s.bytes = s.bob + (mode == kTrial || mode == kMc ? bits : 0);
  return s;
}

// ---------------------------------------------------------------------------
// One block's view of its frame.
// ---------------------------------------------------------------------------

struct Frame {
  const int4* cinfo;    // [M] each internal check's Row
  const int4* binfo;    // [N] each internal bit's Row
  const int* cbit;      // [E + kRun] internal bit of each check edge
  const int* bent;      // [E] (check | slot << 16) of each bit edge
  const int* bit_ext;   // [N] external index of each internal bit
  const int* chk_ext;   // [M] external index of each internal check
  const int* ext_bit;   // [N] internal index of each external bit
  float* tot;           // [N] totals (mc staging: the sort keys)
  float2* pv;           // min-sum: [M] value pairs
  uint32_t* words;      // min-sum: [W][M] edge bits
  float* ext;           // the SPA pair: [max_deg][M]
  uint32_t* syn;        // [M / 32] syndrome bits
  uint32_t* alice;      // [N / 32] Alice's bits
  uint32_t* bob;        // [N / 32] Bob's bits
  int N, M, T, tid;
  bool neg_same;        // the clamp maps every value to the threshold
  uint32_t fill;        // neg_same: every sign bit of the stored words set
  Bounds values;        // the clamp of check->bit values
};

// Where a node's edges sit in a table: slot k of the node at b + k * s, of
// deg slots. Min-sum's tables are node-major (s = 1: a check's edges are
// neighbours, read as b + k); the SPA pair's are slot-major within each
// degree group (s: the group's node count).
struct Row {
  int b, s, deg;
  __device__ __forceinline__ int at(int k) const { return b + k * s; }
};

__device__ __forceinline__ Row row_of(const int4* info, int node) {
  const int4 r = __ldg(info + node);
  return Row{r.x, r.y, r.z};
}

__device__ __forceinline__ int packed_bit(const uint32_t* words, int j) {
  return (words[j >> 5] >> (j & 31)) & 1;
}

// The check->bit value of slot k of a stored check (its pair pv, and w the
// word that holds slot k). An edge with m <= 0 takes -p: f * row_sign * -1
// * eabs and clamp(-x) are the exact negations, unless the clamp's
// threshold is negative, where every clamped value is the threshold itself
// (neg_same: the words are stored with every sign bit set, Frame::fill).
__device__ __forceinline__ float stored_value(float2 pv, uint32_t w, int k) {
  const uint32_t b = w >> ((2 * k) & 31);
  const float v = b & 2u ? pv.y : pv.x;
  return b & 1u ? v : -v;
}

// The running two minima and sign parity of a check's messages; min2 by
// the generic decoder's rule (second).
struct TwoMin {
  float min1 = 0.f, min2 = FLT_MAX;
  int neg = 0;
  __device__ __forceinline__ void add(int k, float mm) {
    const float av = fabsf(mm);
    if (k == 0) {
      min1 = av;
    } else {
      min2 = min_nan(min2, max_nan(min1, av));
      min1 = min_nan(min1, av);
    }
    if (mm < 0.f) neg ^= 1;
  }
  // The second minimum of a check of deg edges: inf where every |m| is inf
  // (deg >= 2), as the plain decoder's tie at the minimum gives; the chain
  // alone would keep the float32 maximum.
  __device__ __forceinline__ float second(int deg) const {
    return (deg >= 2 && isinf(min1)) ? min1 : min2;
  }
  __device__ __forceinline__ float row_sign(int sbit) const {
    return (sbit ? -1.f : 1.f) * (neg == 0 ? 1.f : -1.f);
  }
};

// The stored pair of a new check.
template <bool OFFSET>
__device__ __forceinline__ float2 new_values(const Frame& fr,
                                             const TwoMin& tm, int deg,
                                             int sbit, float f) {
  const float rs = tm.row_sign(sbit);
  return make_float2(clamp_to(minsum_from<OFFSET>(tm.min1, rs, f), fr.values),
                     clamp_to(minsum_from<OFFSET>(tm.second(deg), rs, f),
                              fr.values));
}

// One min-sum check of at most R edges (internal check c, its edges at
// row): loads all its totals before using any (slots past deg read slot
// 0's), turns each into its message clamp(t - v) in place (slots past deg:
// +inf), and writes the check's new compressed form. Returns the decision
// parity of the totals it read.
template <int R, bool ADAPTIVE, bool OFFSET>
__device__ __forceinline__ int minsum_run(const Params& p, const Frame& fr,
                                          int c, Row row, int sbit,
                                          Bounds msg) {
  const int deg = row.deg;
  const float2 old = fr.pv[c];
  const uint32_t ow = fr.words[c];
  float m[R];
#pragma unroll
  for (int k = 0; k < R; ++k) m[k] = fr.tot[__ldg(fr.cbit + row.b + k)];
  TwoMin tm;
  int par = sbit;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k < deg && m[k] <= 0.f) par ^= 1;
    m[k] = k < deg ? clamp_to(m[k] - stored_value(old, ow, k), msg)
                   : INFINITY;
    tm.add(k, m[k]);
  }
  const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
  const float2 nv = new_values<OFFSET>(fr, tm, deg, sbit, fac);
  uint32_t nw = 0u;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (m[k] > 0.f) nw |= 1u << (2 * k);
    if (fabsf(m[k]) == tm.min1) nw |= 2u << (2 * k);
  }
  fr.words[c] = nw | fr.fill;
  fr.pv[c] = nv;
  return par;
}

// One min-sum check of more than kRun edges: two passes over its edges,
// the words of the old form streamed slot by slot, each loaded once and
// before the new form overwrites it. Returns the decision parity of the
// totals it read.
template <bool ADAPTIVE, bool OFFSET>
__device__ int long_check(const Params& p, const Frame& fr, int c, Row row,
                          int sbit, Bounds msg) {
  const int deg = row.deg;
  const float2 old = fr.pv[c];
  uint32_t ow = 0u;
  int ow_idx = -1;
  auto old_value = [&](int k) {
    const int wi = (2 * k) >> 5;
    if (wi != ow_idx) {
      ow = fr.words[(size_t)wi * fr.M + c];
      ow_idx = wi;
    }
    return stored_value(old, ow, k);
  };
  TwoMin tm;
  int par = sbit;
  for (int k = 0; k < deg; ++k) {
    const float t = fr.tot[__ldg(fr.cbit + row.b + k)];
    if (t <= 0.f) par ^= 1;
    tm.add(k, clamp_to(t - old_value(k), msg));
  }
  const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
  const float2 nv = new_values<OFFSET>(fr, tm, deg, sbit, fac);
  uint32_t nw = 0u;
  ow_idx = -1;
  for (int k = 0; k < deg; ++k) {
    const float t = fr.tot[__ldg(fr.cbit + row.b + k)];
    const float mm = clamp_to(t - old_value(k), msg);
    if (mm > 0.f) nw |= 1u << ((2 * k) & 31);
    if (fabsf(mm) == tm.min1) nw |= 2u << ((2 * k) & 31);
    if (((2 * k) & 31) == 30 || k == deg - 1) {
      fr.words[(size_t)((2 * k) >> 5) * fr.M + c] = nw | fr.fill;
      nw = 0u;
    }
  }
  fr.pv[c] = nv;
  return par;
}

// One SPA-pair check. Checks of at most kRun edges keep their terms in
// registers; longer ones park each term in its slot until the new value
// replaces it (spa_row). Returns the decision parity of the totals it read.
template <int CHECK>
__device__ __forceinline__ int spa_check(const Frame& fr, int c, Row row,
                                         int sbit, int it, Bounds msg) {
  const int deg = row.deg;
  float* ext = fr.ext + c;
  const int M = fr.M;
  int par = sbit;
  if (deg <= kRun) {
    // Only the terms stay live across the row; the compiler runs the loads
    // ahead.
    return with_run(deg, [&](auto run) {
      constexpr int R = decltype(run)::value;
      float th[R];
      float prod = sbit ? -1.f : 1.f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k < deg) {
          const float t = fr.tot[__ldg(fr.cbit + row.at(k))];
          const float eo = it ? ext[k * M] : 0.f;
          if (t <= 0.f) par ^= 1;
          th[k] = spa_term<CHECK>(clamp_to(t - eo, msg));
          prod = prod * th[k];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k < deg)
          ext[k * M] = clamp_to(spa_extrinsic<CHECK>(prod / th[k]), fr.values);
      return par;
    });
  }
  spa_row<CHECK>(
      deg, sbit != 0,
      [&](int k) {
        const float t = fr.tot[__ldg(fr.cbit + row.at(k))];
        if (t <= 0.f) par ^= 1;
        const float eo = it ? ext[k * M] : 0.f;
        const float th = spa_term<CHECK>(clamp_to(t - eo, msg));
        ext[k * M] = th;
        return th;
      },
      [&](int k) { return ext[k * M]; },
      [&](int k, float v) { ext[k * M] = clamp_to(v, fr.values); });
  return par;
}

// One check of sweep `it` (msg: the sweep's message clamp). Returns the
// decision parity of the totals it read.
template <bool ADAPTIVE, bool OFFSET, int CHECK>
__device__ __forceinline__ int check_update(const Params& p, const Frame& fr,
                                            int c, int it, Bounds msg) {
  const Row row = row_of(fr.cinfo, c);
  const int sbit = packed_bit(fr.syn, c);
  if constexpr (CHECK != kMinSum) {
    return spa_check<CHECK>(fr, c, row, sbit, it, msg);
  } else {
    if (row.deg > kRun)
      return long_check<ADAPTIVE, OFFSET>(p, fr, c, row, sbit, msg);
    return with_run(row.deg, [&](auto run) {
      constexpr int R = decltype(run)::value;
      return minsum_run<R, ADAPTIVE, OFFSET>(p, fr, c, row, sbit, msg);
    });
  }
}

// The decision parity of check c over the current totals.
__device__ __forceinline__ int check_parity(const Frame& fr, int c) {
  const Row row = row_of(fr.cinfo, c);
  const int deg = row.deg;
  int par = packed_bit(fr.syn, c);
  if (deg <= kRun) {  // the loads in flight together, past deg slot 0's
    return with_run(deg, [&](auto run) {
      constexpr int R = decltype(run)::value;
      float t[R];
#pragma unroll
      for (int k = 0; k < R; ++k)
        t[k] = fr.tot[__ldg(fr.cbit + row.at(k < deg ? k : 0))];
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k < deg && t[k] <= 0.f) par ^= 1;
      return par;
    });
  }
  for (int k = 0; k < deg; ++k)
    if (fr.tot[__ldg(fr.cbit + row.at(k))] <= 0.f) par ^= 1;
  return par;
}

// The channel LLR of internal bit i: +-log_p from Bob's bit (trial and
// mc), or the caller's LLR (decode and frame), read again from global
// memory.
template <bool MC>
__device__ __forceinline__ float channel_llr(const Params& p, const Frame& fr,
                                             size_t fo, int i) {
  if (MC || p.mode == kTrial)
    return packed_bit(fr.bob, i) ? -p.log_p : p.log_p;
  return __ldg(p.llr + fo + __ldg(fr.bit_ext + i));
}

// The stored check->bit value of a bit-major edge entry (check | slot <<
// 16).
template <int CHECK>
__device__ __forceinline__ float edge_value(const Frame& fr, int ent) {
  const int c = ent & 0xffff, slot = (int)((unsigned)ent >> 16);
  if constexpr (CHECK != kMinSum) {
    return fr.ext[slot * fr.M + c];
  } else {
    const uint32_t w =
        fr.words[(size_t)(slot >> 4) * fr.M + c] >> (2 * (slot & 15));
    const float2 pv = fr.pv[c];
    const float v = w & 2u ? pv.y : pv.x;
    return w & 1u ? v : -v;
  }
}

// The total of internal bit i: ((llr + v_0) + v_1) + ... over its edges in
// slot order, kBitRun values loaded before any is added.
template <bool MC, int CHECK>
__device__ __forceinline__ float bit_total(const Params& p, const Frame& fr,
                                           size_t fo, int i) {
  float total = channel_llr<MC>(p, fr, fo, i);
  const Row row = row_of(fr.binfo, i);
  const int deg = row.deg;
  for (int k0 = 0; k0 < deg; k0 += kBitRun) {
    float v[kBitRun];
#pragma unroll
    for (int k = 0; k < kBitRun; ++k) {
      const int q = CHECK == kMinSum ? row.b + k0 + k : row.at(k0 + k);
      if (k0 + k < deg) v[k] = edge_value<CHECK>(fr, __ldg(fr.bent + q));
    }
#pragma unroll
    for (int k = 0; k < kBitRun; ++k)
      if (k0 + k < deg) total = total + v[k];
  }
  return total;
}

// The bit pass: each thread forms the totals of its bits, two at a time so
// that both bits' loads are in flight together.
template <bool MC, int CHECK>
__device__ __forceinline__ void bit_pass(const Params& p, const Frame& fr,
                                         size_t fo) {
  const int N = fr.N, T = fr.T;
  int i = fr.tid;
  for (; i + T < N; i += 2 * T) {
    const float t0 = bit_total<MC, CHECK>(p, fr, fo, i);
    const float t1 = bit_total<MC, CHECK>(p, fr, fo, i + T);
    fr.tot[i] = t0;
    fr.tot[i + T] = t1;
  }
  if (i < N) fr.tot[i] = bit_total<MC, CHECK>(p, fr, fo, i);
}

// ---------------------------------------------------------------------------
// Frame set-up.
// ---------------------------------------------------------------------------

// The mc mode's keys of chunk frame d.frame0 + f: one Philox call per
// counter gives the four external positions 4q .. 4q + 3 their Alice bits
// (packed in external order in alice_ext) and their sort keys (in the
// totals' space); then the exact selection of the num_errors smallest keys,
// Alice's and Bob's bits packed in internal order, and the channel LLRs
// +-log_p of Bob's bits as the first totals. Ends after a barrier with the
// totals written (no barrier after them).
__device__ void mc_stage(const McDraw& d, const Frame& fr, int f,
                         Selection& sel, uint32_t* alice_ext, float log_p) {
  const int N = fr.N, T = fr.T, tid = fr.tid, frame = d.frame0 + f;
  uint32_t* keys = reinterpret_cast<uint32_t*>(fr.tot);
  const int Q = (N + 3) >> 2;
  for (int q0 = 0; q0 < Q; q0 += T) {  // whole warps: T is a multiple of 32
    const int q = q0 + tid;
    uint32_t nib = 0u;
    if (q < Q) {
      const uint4 a = mc_counter_words(d.key, q, frame, kStreamAlice);
      const uint4 e = mc_counter_words(d.key, q, frame, kStreamErrors);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = 4 * q + i;
        if (pos < N) {
          nib |= (aw[i] & 1u) << i;
          keys[pos] = (ew[i] >> d.idx_bits << d.idx_bits) | (uint32_t)pos;
        }
      }
    }
    // Eight lanes' nibbles make one word of Alice's bits.
    uint32_t w = nib << (4 * (tid & 7));
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 4);
    if ((tid & 7) == 0 && q < Q) alice_ext[q >> 3] = w;
  }
  __syncthreads();
  uint32_t kth = 0;
  if (d.num_errors > 0)
    kth = kth_smallest_scan(
        [&](auto visit) {
          for (int l = tid; l < N; l += T) visit(keys[l]);
        },
        d.num_errors, sel);
  // Internal bit i takes the bits of its external position.
  for (int i0 = 0; i0 < N; i0 += T) {
    const int i = i0 + tid;
    int a = 0, b = 0;
    if (i < N) {
      const int j = __ldg(fr.bit_ext + i);
      a = packed_bit(alice_ext, j);
      b = a ^ (d.num_errors > 0 && keys[j] <= kth);
    }
    const uint32_t wa = __ballot_sync(0xffffffffu, a);
    const uint32_t wb = __ballot_sync(0xffffffffu, b);
    if ((tid & 31) == 0 && i < N) {
      fr.alice[i >> 5] = wa;
      fr.bob[i >> 5] = wb;
    }
  }
  __syncthreads();  // every key read
  for (int i = tid; i < N; i += T)
    fr.tot[i] = packed_bit(fr.bob, i) ? -log_p : log_p;
}

// The decode of frame f, from its key bits (trial, mc), its frame and LLRs
// (frame) or its LLRs and syndrome (decode), to its statistics or
// decisions.
template <bool ADAPTIVE, bool OFFSET, bool MC, int CHECK>
__device__ __forceinline__ void decode_frame(const Params& p, const McDraw& d,
                                             const Frame& fr, int f,
                                             Selection& sel,
                                             uint32_t* alice_ext) {
  const int N = fr.N, M = fr.M, T = fr.T, tid = fr.tid;
  const size_t fo = (size_t)f * N;
  if constexpr (MC) {
    mc_stage(d, fr, f, sel, alice_ext, p.log_p);
  } else {
    for (int i0 = 0; i0 < N; i0 += T) {  // whole warps
      const int i = i0 + tid;
      const bool in = i < N;
      const int j = in ? __ldg(fr.bit_ext + i) : 0;
      if (p.mode != kDecode) {
        const uint32_t w =
            __ballot_sync(0xffffffffu, in && (p.alice[fo + j] & 1));
        if ((tid & 31) == 0 && in) fr.alice[i >> 5] = w;
      }
      if (p.mode == kTrial) {
        const bool b = in && p.bob[fo + j] == 1;
        const uint32_t w = __ballot_sync(0xffffffffu, b);
        if ((tid & 31) == 0 && in) fr.bob[i >> 5] = w;
        if (in) fr.tot[i] = b ? -p.log_p : p.log_p;
      } else if (in) {
        fr.tot[i] = p.llr[fo + j];
      }
    }
    __syncthreads();
  }
  // The syndrome bits: the parity of Alice's bits on each check (trial,
  // frame, mc) or the caller's syndrome (decode). Min-sum: every check
  // stored as a message-free one, whose values rebuild as +0 (a -0 pair,
  // negated; +0 where the fill keeps the sign).
  const float zero = fr.neg_same ? 0.f : -0.f;
  for (int c0 = 0; c0 < M; c0 += T) {  // whole warps
    const int c = c0 + tid;
    int bit = 0;
    if (c < M) {
      if (MC || p.mode != kDecode) {
        const Row row = row_of(fr.cinfo, c);
        for (int k = 0; k < row.deg; ++k)
          bit ^= packed_bit(fr.alice, __ldg(fr.cbit + row.at(k)));
      } else {
        bit = p.syn[(size_t)f * M + __ldg(fr.chk_ext + c)] == 1;
      }
      if (CHECK == kMinSum) {
        fr.pv[c] = make_float2(zero, zero);
        for (int w = 0; w < check_words(p.max_deg); ++w)
          fr.words[(size_t)w * M + c] = fr.fill;
      }
    }
    const uint32_t w = __ballot_sync(0xffffffffu, bit);
    if ((tid & 31) == 0 && c < M) fr.syn[c >> 5] = w;
  }
  __syncthreads();

  int converged = 0, iters = p.max_iter;
  for (int it = 0; it < p.max_iter; ++it) {
    // The first sweep reads the channel LLRs unclamped.
    const Bounds msg = bounds(p.use_threshold && it > 0, p);
    int bad = 0;
    for (int c = tid; c < M; c += T)
      bad |= check_update<ADAPTIVE, OFFSET, CHECK>(p, fr, c, it, msg);
    // The adaptive pair: converged on the decisions before this sweep. The
    // others: on the decisions of the previous sweep (none before the
    // first). Either way the totals read are kept.
    if (!__syncthreads_or((ADAPTIVE || it > 0) ? bad : 1)) {
      converged = 1;
      iters = ADAPTIVE ? it + 1 : it;
      break;
    }
    bit_pass<MC, CHECK>(p, fr, fo);
    __syncthreads();
  }
  if (!ADAPTIVE && !converged && p.max_iter > 0) {
    int bad = 0;
    for (int c = tid; c < M; c += T) bad |= check_parity(fr, c);
    if (!__syncthreads_or(bad)) converged = 1;
  }

  if (MC || p.mode != kDecode) {
    int ok = 1;
    for (int i0 = 0; i0 < N; i0 += T) {  // whole warps
      const int i = i0 + tid;
      const uint32_t w = __ballot_sync(0xffffffffu, i < N && fr.tot[i] <= 0.f);
      if ((tid & 31) == 0 && i < N) ok &= w == fr.alice[i >> 5];
    }
    ok = __syncthreads_and(ok);
    if (tid == 0) p.keys[f] = (int8_t)ok;
  } else {
    for (int j = tid; j < N; j += T)
      p.dec_out[fo + j] = fr.tot[__ldg(fr.ext_bit + j)] <= 0.f ? 1 : 0;
  }
  if (tid == 0) {
    p.conv[f] = (int8_t)converged;
    p.iters[f] = iters;
  }
  __syncthreads();  // the next frame overwrites the shared planes
}

// MC: the mc mode (d: what it draws from; unused by the other modes),
// compiled apart so that its staging's registers do not weigh on the other
// modes. CHECK: the check update (spa.cuh: kMinSum, or the SPA pair).
// SLICE: the checks in the block's global slice.
template <bool ADAPTIVE, bool OFFSET, bool MC, int CHECK, bool SLICE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_generic_kernel(Params p, McDraw d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SharedLayout lay =
      shared_layout(p.n, p.m, p.max_deg, CHECK, SLICE, p.mode);
  Frame fr;
  fr.cinfo = reinterpret_cast<const int4*>(p.table);
  fr.binfo = fr.cinfo + p.m;
  fr.cbit = reinterpret_cast<const int*>(fr.binfo + p.n);
  fr.bent = fr.cbit + p.e + kRun;
  fr.bit_ext = fr.bent + p.e;
  fr.chk_ext = fr.bit_ext + p.n;
  fr.ext_bit = fr.chk_ext + p.m;
  fr.tot = reinterpret_cast<float*>(smem);
  if constexpr (SLICE) {
    float* slice =
        p.slice + (size_t)blockIdx.x * slice_floats(p.m, p.max_deg, CHECK);
    fr.pv = reinterpret_cast<float2*>(slice);
    fr.words = reinterpret_cast<uint32_t*>(slice + 2 * (size_t)p.m);
    fr.ext = slice;
  } else {
    fr.pv = reinterpret_cast<float2*>(smem + lay.msgs);
    fr.words = reinterpret_cast<uint32_t*>(smem + lay.msgs + 8 * (size_t)p.m);
    fr.ext = reinterpret_cast<float*>(smem + lay.msgs);
  }
  fr.syn = reinterpret_cast<uint32_t*>(smem + lay.syn);
  fr.alice = reinterpret_cast<uint32_t*>(smem + lay.alice);
  fr.bob = reinterpret_cast<uint32_t*>(smem + lay.bob);
  fr.N = p.n;
  fr.M = p.m;
  fr.T = blockDim.x;
  fr.tid = threadIdx.x;
  fr.neg_same = p.use_threshold && p.threshold < 0.f;
  fr.fill = fr.neg_same ? 0x55555555u : 0u;
  fr.values = bounds(p.use_threshold, p);
  Selection& sel = *reinterpret_cast<Selection*>(smem + lay.msgs);
  uint32_t* alice_ext = reinterpret_cast<uint32_t*>(smem + lay.alice_ext);

  for (int f = blockIdx.x; f < p.batch; f += gridDim.x)
    decode_frame<ADAPTIVE, OFFSET, MC, CHECK>(p, d, fr, f, sel, alice_ext);
}

typedef void (*KernelFn)(Params, McDraw);

template <bool ADAPTIVE, bool OFFSET, bool MC, int CHECK>
KernelFn pick(bool slice) {
  return slice ? fused_generic_kernel<ADAPTIVE, OFFSET, MC, CHECK, true>
               : fused_generic_kernel<ADAPTIVE, OFFSET, MC, CHECK, false>;
}

// flags: bit 0 adaptive, bit 1 offset (OMSA/AOMSA), bits 2-3 the check
// update (4 SPA, 8 SPA-lin; neither adaptive nor offset), bit 4 (kSlice)
// the checks in global memory. nullptr for flags without a kernel.
template <bool MC>
KernelFn kernel_of(int flags) {
  const int check = (flags >> 2) & 3;
  const bool slice = (flags & kSlice) != 0;
  if ((flags & ~31) != 0) return nullptr;
  if (check != kMinSum) {
    if ((flags & 3) != 0) return nullptr;
    if (check == kSpa) return pick<false, false, MC, kSpa>(slice);
    if (check == kSpaLin) return pick<false, false, MC, kSpaLin>(slice);
    return nullptr;
  }
  switch (flags & 3) {
    case 0: return pick<false, false, MC, kMinSum>(slice);
    case 1: return pick<true, false, MC, kMinSum>(slice);
    case 2: return pick<false, true, MC, kMinSum>(slice);
    default: return pick<true, true, MC, kMinSum>(slice);
  }
}

KernelFn kernel_for(int flags, int mode) {
  return mode == kMc ? kernel_of<true>(flags) : kernel_of<false>(flags);
}

bool shape_ok(int n, int m, int e, int max_deg) {
  return n >= 1 && m >= 1 && m <= 65536 && e >= 1 && max_deg >= 1 &&
         max_deg <= 65536 && n < (1 << 24);
}

size_t shared_bytes(int n, int m, int max_deg, int flags, int mode) {
  return shared_layout(n, m, max_deg, (flags >> 2) & 3,
                       (flags & kSlice) != 0, mode)
      .bytes;
}

// The kernel of these flags and mode with its shared memory set, or a CUDA
// error.
int configure(KernelFn kernel, size_t smem) {
  if (kernel == nullptr || smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch(const Params& p, int flags, int grid, int threads,
           cudaStream_t stream, const McDraw& d = McDraw{}) {
  const bool slice = (flags & kSlice) != 0;
  if (!shape_ok(p.n, p.m, p.e, p.max_deg) || p.batch < 1 || grid < 1 ||
      grid > p.batch || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || (slice && p.slice == nullptr))
    return (int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags, p.mode);
  const size_t smem = shared_bytes(p.n, p.m, p.max_deg, flags, p.mode);
  int err = configure(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, stream>>>(p, d);
  return (int)cudaGetLastError();
}

Params base_params(int batch, const int32_t* table, int n, int m, int e,
                   int max_deg, int use_threshold, int max_iter, int mode,
                   float primary, float secondary, float threshold,
                   float* slice, int8_t* conv, int32_t* iters) {
  Params p{};
  p.table = table;
  p.slice = slice;
  p.n = n;
  p.m = m;
  p.e = e;
  p.max_deg = max_deg;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = mode;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.conv = conv;
  p.iters = iters;
  return p;
}

}  // namespace

extern "C" {

// The layout the wrapper's plan mirrors (ops/fused_generic.py::
// launch_plan): shared bytes of one block and floats of one block's global
// slice (mode 0 decode, 1 trial, 2 frame, 3 mc; flags as the launch's).
long long fused_generic_shared_bytes(int n, int m, int max_deg, int flags,
                                     int mode) {
  return (long long)shared_bytes(n, m, max_deg, flags, mode);
}

long long fused_generic_slice_floats(int m, int max_deg, int flags) {
  return (long long)slice_floats(m, max_deg, (flags >> 2) & 3);
}

int fused_generic_max_threads() { return kMaxThreads; }

// Blocks of this configuration and mode that fit on one SM and on the
// current device at once (blocks per SM times the SM count; per_sm, when
// given, receives the first), or a negative CUDA error.
int fused_generic_resident_blocks(int n, int m, int e, int max_deg, int flags,
                                  int mode, int threads, int* per_sm_out) {
  if (!shape_ok(n, m, e, max_deg) || mode < kDecode || mode > kMc)
    return -(int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags, mode);
  const size_t smem = shared_bytes(n, m, max_deg, flags, mode);
  int err = configure(kernel, smem);
  if (err != 0) return -err;
  int per_sm = 0, device = 0, sms = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           threads, smem);
  if (err == 0) err = (int)cudaGetDevice(&device);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (err != 0) return -err;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  return per_sm * sms;
}

int fused_generic_trial(const int8_t* alice, const int8_t* bob, int batch,
                        const int32_t* table, int n, int m, int e,
                        int max_deg, int flags, int use_threshold,
                        int max_iter, float log_p, float primary,
                        float secondary, float threshold, float* slice,
                        int grid, int threads, int8_t* conv, int8_t* keys,
                        int32_t* iters, void* stream) {
  Params p = base_params(batch, table, n, m, e, max_deg, use_threshold,
                         max_iter, kTrial, primary, secondary, threshold,
                         slice, conv, iters);
  p.alice = alice;
  p.bob = bob;
  p.log_p = log_p;
  p.keys = keys;
  return launch(p, flags, grid, threads, static_cast<cudaStream_t>(stream));
}

int fused_generic_decode(const float* llr, const int8_t* syn, int batch,
                         const int32_t* table, int n, int m, int e,
                         int max_deg, int flags, int use_threshold,
                         int max_iter, float primary, float secondary,
                         float threshold, float* slice, int grid, int threads,
                         int8_t* dec, int8_t* conv, int32_t* iters,
                         void* stream) {
  Params p = base_params(batch, table, n, m, e, max_deg, use_threshold,
                         max_iter, kDecode, primary, secondary, threshold,
                         slice, conv, iters);
  p.llr = llr;
  p.syn = syn;
  p.dec_out = dec;
  return launch(p, flags, grid, threads, static_cast<cudaStream_t>(stream));
}

int fused_generic_frame(const int8_t* alice, const float* llr, int batch,
                        const int32_t* table, int n, int m, int e,
                        int max_deg, int flags, int use_threshold,
                        int max_iter, float primary, float secondary,
                        float threshold, float* slice, int grid, int threads,
                        int8_t* conv, int8_t* keys, int32_t* iters,
                        void* stream) {
  Params p = base_params(batch, table, n, m, e, max_deg, use_threshold,
                         max_iter, kFrame, primary, secondary, threshold,
                         slice, conv, iters);
  p.alice = alice;
  p.llr = llr;
  p.keys = keys;
  return launch(p, flags, grid, threads, static_cast<cudaStream_t>(stream));
}

int fused_generic_mc(unsigned k0, unsigned k1, int frame0, int num_errors,
                     int batch, const int32_t* table, int n, int m, int e,
                     int max_deg, int flags, int use_threshold, int max_iter,
                     float log_p, float primary, float secondary,
                     float threshold, float* slice, int grid, int threads,
                     int8_t* conv, int8_t* keys, int32_t* iters,
                     void* stream) {
  Params p = base_params(batch, table, n, m, e, max_deg, use_threshold,
                         max_iter, kMc, primary, secondary, threshold, slice,
                         conv, iters);
  p.log_p = log_p;
  p.keys = keys;
  const McDraw d{McKey{k0, k1}, frame0, num_errors, mc_idx_bits(n)};
  if (num_errors < 0 || num_errors > n || frame0 < 0)
    return (int)cudaErrorInvalidValue;
  return launch(p, flags, grid, threads, static_cast<cudaStream_t>(stream), d);
}

}  // extern "C"
