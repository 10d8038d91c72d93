// Fused QC-LDPC decoder for Hopper (sm_90a): one thread block decodes one
// frame, from raw keys (trial mode), from LLRs and a syndrome (decode mode),
// from a rate-adapted frame and its LLRs (frame mode) or from keys it draws
// itself (mc mode) to its per-frame statistics or decisions.
//
// Replaces the TPU kernel qkd_ldpc_v_tpu/ops/pallas_qc.py::_build.kernel
// (trial, decode, frame and mc modes; the min-sum family
// NMSA/OMSA/ANMSA/AOMSA on the flooding and layered schedules, and the SPA
// pair SPA / SPA-lin-approx on the flooding schedule, whose check update is
// csrc/spa.cuh). The plain torch versions it is held to, bit for bit, are
// in qkd_ldpc_v_tpu_torch/ops/qc_decoder.py, and for the mc mode's keys
// ops/channel.py::mc_channel.
//
// Modes: trial forms the channel LLRs +-log_p from Bob's keys and Alice's
// syndrome from her keys, and compares the decisions with her keys; decode
// reads the caller's LLRs and syndrome and writes the decisions; frame
// reads the caller's LLRs as decode does and forms the syndrome and the key
// compare from Alice's frame as trial does; mc is trial on keys drawn in the
// kernel from the chunk's Philox stream (philox.cuh), so that nothing of
// size [B, N] touches HBM.
//
// Circulant convention: check-aligned index z of block edge (r, c, s) is
// bit (c, (z + s) mod Z).
//
// Design (ops/fused_qc.py::launch_plan mirrors the shared layout).
//   * Launch shape: a block of Z threads rounded up to a warp multiple per
//     frame; thread z < Z owns check z of every block-row. Per frame, in
//     shared memory: the f32 bit totals (N), the check->bit messages, and
//     Alice's and Bob's key bits packed 32 to a word (trial, frame, mc).
//     Decisions are read from the totals (total <= 0 -> 1).
//   * Min-sum messages are stored compressed per check, as the streamed QC
//     kernel stores them: a value pair (p1, p2), the clamped check->bit
//     values of an edge whose message is positive with |m| != min1 and with
//     |m| == min1, and W = ceil(2 * max row degree / 32) word planes of two
//     bits per edge (m > 0, |m| == min1); an edge with m <= 0 takes -p, the
//     exact negation. 12 bytes per check of degree <= 16 in place of 4 per
//     edge, and no message lives in a per-thread array. Each frame starts
//     from a stored check whose values rebuild as +0, so no sweep tests
//     whether old values exist. The SPA pair has no two-minimum form: its
//     f32 check->bit values ([num_be][Z]) sit in shared memory where a
//     frame's fit, else in a per-block global slice (a persistent grid of
//     as many blocks as fit at once walks the frames).
//   * Addresses: the prologue turns each block edge into (c Z + s, Z - s),
//     so an edge's bit is one compare and one add away, keeps them again by
//     row padded to kRun slots, and turns each column's edges (base-row
//     order) into the address of their stored check. A check of at most
//     kRun edges runs branch-free over a register run of 6, 8, ..., 16
//     slots (the shortest that holds it): all its totals are loaded before
//     any is used, and slots past its degree read a real total and take
//     the message +inf, which moves no minimum, sign or parity.
//   * Flooding stores check->bit values, not bit->check messages: each
//     message is formed as clamp(t - e) when the check pass reads it (the
//     first sweep's channel messages unclamped: the clamp's bounds are
//     +-inf there, and wherever the clamp is off). The bit pass is by bit
//     ownership: thread z forms the totals of bits (c, z) as
//     ((llr + e_r0) + e_r1) + ... over its column's edges in base-row order
//     (the plain decode_flooding's association), so no LLR plane is kept:
//     trial and mc modes form the LLR from Bob's packed bit, decode and
//     frame modes read it again from global memory (L2). Two barriers an
//     iteration. The convergence test rides in the next check pass on the
//     same totals (a frame whose checks all hold from the second sweep on
//     stops with iters = it, its pass's messages dropped); one parity-only
//     pass follows the last sweep. The adaptive pair tests the decisions it
//     reads at the top of each sweep and takes each check's factor from
//     the same parity.
//   * Layered keeps block-rows in storage order with a barrier between rows
//     and writes t + (val - E); within a row each column appears once and a
//     circulant maps distinct checks to distinct bits, so a row updates the
//     totals without races, and a last-row check sees its final totals:
//     the full parity test runs only where every last-row check holds.
//   * mc: one Philox call serves the four positions of its counter; Alice's
//     bits and the sort keys are drawn once, the keys in the totals' space
//     and the selection state (philox.cuh::Selection, its bucket walk by
//     one warp) in the messages' space, both dead before the decode
//     starts, and Alice's bits stay packed to the key compare.
//   * Exactness: -fmad=false, no fast math and no flush-to-zero; min.NaN /
//     max.NaN (rate-adapted LLRs carry the float32 maximum on shortened
//     bits, so sums can overflow to inf and inf - inf gives NaN, which
//     torch.minimum / torch.maximum keep); a per-frame exit with the
//     decisions of that moment, which equals the plain versions' frozen
//     decision planes.
//
// What bounds it on this card (measured on the headline code, N=10240,
// Z=512, with scripts/variants_fused_qc.py; PERF.md, section 6): a frame
// takes 83 KB of shared memory in mc mode, so 2 blocks of 512 threads share
// an SM, at 64 registers (the layered instantiations spill about 100
// bytes). Neither the barriers nor the warps in flight hold it: without
// the layered barrier between block-rows two sweeps ran 6 % faster, and
// with one block per SM in place of two 5 % (layered) and 14 % (flooding)
// slower, not twice. What holds it is the issue of the check update's
// instructions, a register run's worth per edge slot, where each slot past
// a row's degree costs a slot's work (every check in the 16-slot run: two
// layered sweeps 50 % slower), and the mc staging (draw, selection,
// syndrome, key compare): about 1.7 ms of a layered 16384-frame chunk of
// 8.3 ms.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "spa.cuh"

namespace {

constexpr int kMaxZ = 1024;
constexpr int kMaxBlockEdges = 256;
constexpr int kMaxBaseChecks = 64;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
// Checks of at most kRun edges (one word of edge bits) keep their totals in
// registers, all loads in flight at once, in a register run of 6, 8, ...,
// kRun slots (with_run: the shortest that holds them; each slot past the
// degree costs a slot's work, and the longest run spills); longer ones
// take two passes.
constexpr int kRun = 16;
template <int R>
struct Run {
  static constexpr int value = R;
};

// f(Run<R>{}) for the shortest run R of 6, 8, 10, 12, 14 and kRun edges
// that holds deg <= kRun edges.
template <typename F>
__device__ __forceinline__ int with_run(int deg, F&& f) {
  if (deg <= 6) return f(Run<6>{});
  if (deg <= 8) return f(Run<8>{});
  if (deg <= 10) return f(Run<10>{});
  if (deg <= 12) return f(Run<12>{});
  if (deg <= 14) return f(Run<14>{});
  return f(Run<kRun>{});
}

// Columns of at most kColRun edges load their stored values together.
constexpr int kColRun = 4;
// Launch flag: the SPA pair's messages in a per-block global slice.
constexpr int kSpaGlobal = 32;

enum Mode { kDecode = 0, kTrial = 1, kFrame = 2, kMc = 3 };

struct Params {
  const int8_t* alice;    // trial, frame: [B, N] 0/1
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr;       // decode, frame: [B, N]
  const int8_t* syn;      // decode: [B, M] 0/1
  const int32_t* table;   // see ops/fused_qc.py::fused_table
  float* slice;           // the SPA pair in global memory: [grid][num_be][Z]
  int mb, nb, z, num_be, max_deg, batch, max_iter, use_threshold, mode;
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

// The min-sum check->bit value (unclamped) from the two bits of the edge's
// message that it depends on: excl = m > 0 ? 1 : -1 and eabs = |m| == min1
// ? min2 : min1 (plain: ops/qc_decoder.py::_RowUpdate.__call__).
template <bool OFFSET>
__device__ __forceinline__ float minsum_from(float excl, float eabs,
                                             float row_sign, float f) {
  if (OFFSET) return row_sign * excl * max_nan(eabs - f, 0.f);
  return f * row_sign * excl * eabs;
}

// ---------------------------------------------------------------------------
// Layout (mirrored by ops/fused_qc.py::launch_plan).
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline int threads_for(int z) { return (z + 31) / 32 * 32; }

// Words of one compressed check: two bits per edge.
__host__ __device__ inline int check_words(int max_deg) {
  return (2 * max_deg + 31) / 32;
}

// Byte offsets of one block's shared memory: the column entries (int4 per
// block edge, in column order), the edge addresses (int2 per block edge in
// storage order, then kRun per block-row, padded with an address that
// reads a real total), row_ptr, col_ptr, the totals, the messages (min-sum:
// the value pairs, then the word planes at `words`; the SPA pair in shared
// memory: f32 [num_be][Z]; mc: at least the selection state, which the
// messages' space holds in the prologue), Alice's and Bob's packed bits.
struct SharedLayout {
  size_t ea, eap, row_ptr, col_ptr, tot, msgs, words, alice, bob, bytes;
};

__host__ __device__ inline SharedLayout shared_layout(int mb, int nb, int z,
                                                      int num_be, int max_deg,
                                                      int check,
                                                      bool spa_global,
                                                      int mode) {
  SharedLayout s;
  const size_t n = (size_t)nb * z, m = (size_t)mb * z;
  s.ea = 16 * (size_t)num_be;
  s.eap = s.ea + 8 * (size_t)num_be;
  s.row_ptr = s.eap + 8 * (size_t)kRun * mb;
  s.col_ptr = s.row_ptr + 4 * (size_t)(mb + 1);
  s.tot = align16(s.col_ptr + 4 * (size_t)(nb + 1));
  s.msgs = align16(s.tot + 4 * n);
  s.words = s.msgs + 8 * m;
  size_t msgs;
  if (check == kMinSum)
    msgs = 8 * m + 4 * (size_t)check_words(max_deg) * m;
  else
    msgs = spa_global ? 0 : 4 * (size_t)num_be * z;
  if (mode == kMc && msgs < sizeof(Selection)) msgs = sizeof(Selection);
  s.alice = align16(s.msgs + msgs);
  const size_t bits = 4 * ((n + 31) / 32);
  s.bob = s.alice + (mode == kDecode ? 0 : bits);
  s.bytes = s.bob + (mode == kTrial || mode == kMc ? bits : 0);
  return s;
}

// ---------------------------------------------------------------------------
// One block's view of its frame.
// ---------------------------------------------------------------------------

struct Frame {
  const int4* ce;       // per column entry: ((row or edge) Z - s, s,
                        // (slot / 16) M, 2 (slot % 16))
  const int2* ea;       // per block edge: (c Z + s, Z - s)
  const int2* eap;      // [mb][kRun]: ea by row, padded with (0, Z)
  const int* row_ptr;
  const int* col_ptr;
  float* tot;           // [N] totals (mc prologue: the sort keys)
  float2* pv;           // min-sum: [M] value pairs
  uint32_t* words;      // min-sum: [W][M] edge bits
  float* ext;           // the SPA pair: [num_be][Z]
  uint32_t* alice;      // [N / 32] Alice's bits
  uint32_t* bob;        // [N / 32] Bob's bits
  int Z, M, N, T, tid;
  bool neg_same;        // the clamp maps every value to the threshold
  uint32_t fill;        // neg_same: every sign bit of the stored words set
  Bounds values;        // the clamp of check->bit values
};

// The bit c Z + (z + s) mod Z of block edge a = (c Z + s, Z - s) at check z.
__device__ __forceinline__ int edge_bit(int2 a, int z, int Z) {
  return a.x + z - (z >= a.y ? Z : 0);
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

// The stored pair of a new check.
template <bool OFFSET>
__device__ __forceinline__ float2 new_values(const Frame& fr, float min1,
                                             float min2, float row_sign,
                                             float f) {
  return make_float2(
      clamp_to(minsum_from<OFFSET>(1.f, min1, row_sign, f), fr.values),
      clamp_to(minsum_from<OFFSET>(1.f, min2, row_sign, f), fr.values));
}

// The running two minima and sign parity of a check's messages.
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
  __device__ __forceinline__ float row_sign(int sbit) const {
    return (sbit ? -1.f : 1.f) * (neg == 0 ? 1.f : -1.f);
  }
};

// The words of a check of deg <= 16 edges that its slots may set.
__device__ __forceinline__ uint32_t slot_mask(int deg) {
  return deg >= 16 ? 0xffffffffu : (1u << (2 * deg)) - 1u;
}

// One layered min-sum check of at most R edges (row r, index z, syndrome
// bit sbit): loads all its totals before using any, keeps them and their
// addresses, forms each message t - E again in the second loop, and writes
// t + (val - E) and the check's new compressed form. Slots past deg read
// the total at z (a real one) and take the message +inf, which moves no
// minimum, no sign and no parity. Returns the decision parity of the
// totals it leaves.
template <int R, bool ADAPTIVE, bool OFFSET>
__device__ __forceinline__ int layered_run(const Params& p, const Frame& fr,
                                           int r, int z, int sbit, int deg) {
  const int Z = fr.Z, q = r * Z + z;
  const float2 old = fr.pv[q];
  const uint32_t ow = fr.words[q];
  const int2* ep = fr.eap + r * kRun;
  float t[R];
  int a[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    a[k] = edge_bit(ep[k], z, Z);
    t[k] = fr.tot[a[k]];
  }
  TwoMin tm;
  int par = sbit;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float mm = k < deg ? t[k] - stored_value(old, ow, k) : INFINITY;
    tm.add(k, mm);
    if (ADAPTIVE && k < deg && t[k] <= 0.f) par ^= 1;
  }
  const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
  const float2 nv = new_values<OFFSET>(fr, tm.min1, tm.min2,
                                       tm.row_sign(sbit), fac);
  const float2 nn = fr.neg_same ? nv : make_float2(-nv.x, -nv.y);
  uint32_t nw = 0u;
  int left = sbit;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float eo = stored_value(old, ow, k);
    const float mm = t[k] - eo;
    const bool pos = mm > 0.f, eq = fabsf(mm) == tm.min1;
    if (pos) nw |= 1u << (2 * k);
    if (eq) nw |= 2u << (2 * k);
    const float val = pos ? (eq ? nv.y : nv.x) : (eq ? nn.y : nn.x);
    const float tn = t[k] + (val - eo);
    if (k < deg) {
      fr.tot[a[k]] = tn;
      if (tn <= 0.f) left ^= 1;
    }
  }
  fr.words[q] = (nw | fr.fill) & slot_mask(deg);
  fr.pv[q] = nv;
  return left;
}

// One flooding min-sum check of at most R edges: loads all its totals
// before using any, turns each into its message clamp(t - E) in place
// (slots past deg: +inf), and writes the check's new compressed form.
// Returns the decision parity of the totals it read.
template <int R, bool ADAPTIVE, bool OFFSET>
__device__ __forceinline__ int flooding_run(const Params& p, const Frame& fr,
                                            int r, int z, int sbit, int deg,
                                            Bounds msg) {
  const int Z = fr.Z, q = r * Z + z;
  const float2 old = fr.pv[q];
  const uint32_t ow = fr.words[q];
  const int2* ep = fr.eap + r * kRun;
  float m[R];
#pragma unroll
  for (int k = 0; k < R; ++k) m[k] = fr.tot[edge_bit(ep[k], z, Z)];
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
  const float2 nv = new_values<OFFSET>(fr, tm.min1, tm.min2,
                                       tm.row_sign(sbit), fac);
  uint32_t nw = 0u;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (m[k] > 0.f) nw |= 1u << (2 * k);
    if (fabsf(m[k]) == tm.min1) nw |= 2u << (2 * k);
  }
  fr.words[q] = (nw | fr.fill) & slot_mask(deg);
  fr.pv[q] = nv;
  return par;
}

// One min-sum check of more than kRun edges: two passes over its edges,
// the words of the old form streamed slot by slot, each loaded once and
// before the new form overwrites it. Returns the decision parity of the
// totals it read (flooding) or of those it leaves (layered).
template <bool LAYERED, bool ADAPTIVE, bool OFFSET>
__device__ int long_check(const Params& p, const Frame& fr, int r, int z,
                          int sbit, int b, int deg, Bounds msg) {
  const int Z = fr.Z, q = r * Z + z;
  const float2 old = fr.pv[q];
  uint32_t ow = 0u;
  int ow_idx = -1;
  auto old_value = [&](int k) {
    const int wi = (2 * k) >> 5;
    if (wi != ow_idx) {
      ow = fr.words[(size_t)wi * fr.M + q];
      ow_idx = wi;
    }
    return stored_value(old, ow, k);
  };
  auto message = [&](float t, float eo) {
    return LAYERED ? t - eo : clamp_to(t - eo, msg);
  };
  TwoMin tm;
  int par = sbit;
  for (int k = 0; k < deg; ++k) {
    const float t = fr.tot[edge_bit(fr.ea[b + k], z, Z)];
    if (t <= 0.f) par ^= 1;
    tm.add(k, message(t, old_value(k)));
  }
  const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
  const float2 nv = new_values<OFFSET>(fr, tm.min1, tm.min2,
                                       tm.row_sign(sbit), fac);
  const float2 nn = fr.neg_same ? nv : make_float2(-nv.x, -nv.y);
  uint32_t nw = 0u;
  int left = sbit;
  ow_idx = -1;
  for (int k = 0; k < deg; ++k) {
    const int a = edge_bit(fr.ea[b + k], z, Z);
    const float t = fr.tot[a];
    const float eo = old_value(k);
    const float mm = message(t, eo);
    const bool pos = mm > 0.f, eq = fabsf(mm) == tm.min1;
    if (pos) nw |= 1u << ((2 * k) & 31);
    if (eq) nw |= 2u << ((2 * k) & 31);
    if (LAYERED) {
      const float val = pos ? (eq ? nv.y : nv.x) : (eq ? nn.y : nn.x);
      const float tn = t + (val - eo);
      fr.tot[a] = tn;
      if (tn <= 0.f) left ^= 1;
    }
    if (((2 * k) & 31) == 30 || k == deg - 1) {
      fr.words[(size_t)((2 * k) >> 5) * fr.M + q] = nw | fr.fill;
      nw = 0u;
    }
  }
  fr.pv[q] = nv;
  return LAYERED ? left : par;
}

// One min-sum check of sweep `it` (msg: the flooding message clamp of the
// sweep). Returns its decision parity as the checks above do.
template <bool LAYERED, bool ADAPTIVE, bool OFFSET>
__device__ __forceinline__ int minsum_check(const Params& p, const Frame& fr,
                                            int r, int z, int sbit,
                                            Bounds msg) {
  const int b = fr.row_ptr[r], deg = fr.row_ptr[r + 1] - b;
  if (deg > kRun)
    return long_check<LAYERED, ADAPTIVE, OFFSET>(p, fr, r, z, sbit, b, deg,
                                                 msg);
  return with_run(deg, [&](auto run) {
    constexpr int R = decltype(run)::value;
    if (LAYERED)
      return layered_run<R, ADAPTIVE, OFFSET>(p, fr, r, z, sbit, deg);
    return flooding_run<R, ADAPTIVE, OFFSET>(p, fr, r, z, sbit, deg, msg);
  });
}

// One SPA-pair check (flooding). Checks of at most kRun edges keep their
// terms in registers; longer ones park each term in its edge's slot until
// the new value replaces it (spa_row). Returns the decision parity of the
// totals it read.
template <int CHECK>
__device__ __forceinline__ int spa_check(const Frame& fr, int r, int z,
                                         int sbit, int it, Bounds msg) {
  const int Z = fr.Z, b = fr.row_ptr[r], deg = fr.row_ptr[r + 1] - b;
  float* ext = fr.ext;
  int par = sbit;
  if (deg <= kRun) {
    // Only the terms stay live across the row (totals and old values as
    // well spill at 64 registers); the compiler runs the loads ahead.
    return with_run(deg, [&](auto run) {
      constexpr int R = decltype(run)::value;
      float th[R];
      float prod = sbit ? -1.f : 1.f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k < deg) {
          const float t = fr.tot[edge_bit(fr.ea[b + k], z, Z)];
          const float eo = it ? ext[(b + k) * Z + z] : 0.f;
          if (t <= 0.f) par ^= 1;
          th[k] = spa_term<CHECK>(clamp_to(t - eo, msg));
          prod = prod * th[k];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k < deg)
          ext[(b + k) * Z + z] =
              clamp_to(spa_extrinsic<CHECK>(prod / th[k]), fr.values);
      return par;
    });
  }
  spa_row<CHECK>(
      deg, sbit != 0,
      [&](int k) {
        const int e = b + k;
        const float t = fr.tot[edge_bit(fr.ea[e], z, Z)];
        if (t <= 0.f) par ^= 1;
        const float eo = it ? ext[e * Z + z] : 0.f;
        const float th = spa_term<CHECK>(clamp_to(t - eo, msg));
        ext[e * Z + z] = th;
        return th;
      },
      [&](int k) { return ext[(b + k) * Z + z]; },
      [&](int k, float v) { ext[(b + k) * Z + z] = clamp_to(v, fr.values); });
  return par;
}

// The decision parity of one check over the current totals.
__device__ __forceinline__ int check_parity(const Frame& fr, int r, int z,
                                            int sbit) {
  int par = sbit;
  const int b = fr.row_ptr[r], deg = fr.row_ptr[r + 1] - b;
  if (deg <= kRun) {  // the loads in flight together, past deg at z
    const int2* ep = fr.eap + r * kRun;
    return with_run(deg, [&](auto run) {
      constexpr int R = decltype(run)::value;
      float t[R];
#pragma unroll
      for (int k = 0; k < R; ++k) t[k] = fr.tot[edge_bit(ep[k], z, fr.Z)];
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (k < deg && t[k] <= 0.f) par ^= 1;
      return par;
    });
  }
  for (int e = b; e < b + deg; ++e)
    if (fr.tot[edge_bit(fr.ea[e], z, fr.Z)] <= 0.f) par ^= 1;
  return par;
}

// The channel LLR of frame bit j: +-log_p from Bob's bit (trial and mc), or
// the caller's LLR (decode and frame), read again from global memory.
template <bool MC>
__device__ __forceinline__ float channel_llr(const Params& p, const Frame& fr,
                                             size_t fo, int j) {
  if (MC || p.mode == kTrial)
    return packed_bit(fr.bob, j) ? -p.log_p : p.log_p;
  return __ldg(p.llr + fo + j);
}

// The stored check->bit value of column entry ent at check-side index z of
// its bit: the check (r, (z - s) mod Z).
template <int CHECK>
__device__ __forceinline__ float column_value(const Frame& fr, int4 ent,
                                              int z) {
  const int q = ent.x + z + (z < ent.y ? fr.Z : 0);
  if constexpr (CHECK != kMinSum) {
    return fr.ext[q];
  } else {
    const uint32_t w = fr.words[q + ent.z] >> ent.w;
    const float2 pv = fr.pv[q];
    const float v = w & 2u ? pv.y : pv.x;
    return w & 1u ? v : -v;
  }
}

// The total of bit (c, z): ((llr + e_r0) + e_r1) + ... over its column's
// edges in base-row order. Columns of at most kColRun edges load their
// values before adding any, so the loads are in flight together.
template <bool MC, int CHECK>
__device__ __forceinline__ float bit_total(const Params& p, const Frame& fr,
                                           size_t fo, int c, int z) {
  float total = channel_llr<MC>(p, fr, fo, c * fr.Z + z);
  const int cb = fr.col_ptr[c], cdeg = fr.col_ptr[c + 1] - cb;
  if (cdeg <= kColRun) {
    float v[kColRun];
#pragma unroll
    for (int i = 0; i < kColRun; ++i)
      if (i < cdeg) v[i] = column_value<CHECK>(fr, fr.ce[cb + i], z);
#pragma unroll
    for (int i = 0; i < kColRun; ++i)
      if (i < cdeg) total = total + v[i];
  } else {
    for (int i = 0; i < cdeg; ++i)
      total = total + column_value<CHECK>(fr, fr.ce[cb + i], z);
  }
  return total;
}

// The flooding bit pass: thread z forms the totals of bits (c, z), two
// columns at a time so that both columns' loads are in flight together.
template <bool MC, int CHECK>
__device__ __forceinline__ void bit_pass(const Params& p, const Frame& fr,
                                         size_t fo, int z) {
  const int nb = p.nb, Z = fr.Z;
  int c = 0;
  for (; c + 1 < nb; c += 2) {
    const float t0 = bit_total<MC, CHECK>(p, fr, fo, c, z);
    const float t1 = bit_total<MC, CHECK>(p, fr, fo, c + 1, z);
    fr.tot[c * Z + z] = t0;
    fr.tot[(c + 1) * Z + z] = t1;
  }
  if (c < nb) fr.tot[c * Z + z] = bit_total<MC, CHECK>(p, fr, fo, c, z);
}

// ---------------------------------------------------------------------------
// Frame set-up.
// ---------------------------------------------------------------------------

// The mc mode's keys of chunk frame d.frame0 + f: one Philox call per
// counter gives the four positions 4q .. 4q + 3 their Alice bits (packed
// in Alice's words) and their sort keys (in the totals' space); then the
// exact selection of the num_errors smallest keys, and Bob's bits, packed
// and as the channel LLRs +-log_p, each written over its own key. Ends on
// a barrier.
__device__ void mc_prologue(const McDraw& d, const Frame& fr, int f,
                            Selection& sel, float log_p) {
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
    if ((tid & 7) == 0 && q < Q) fr.alice[q >> 3] = w;
  }
  __syncthreads();
  uint32_t kth = 0;
  if (d.num_errors > 0)
    kth = kth_smallest_scan(
        [&](auto visit) {
          for (int l = tid; l < N; l += T) visit(keys[l]);
        },
        d.num_errors, sel);
  for (int l0 = 0; l0 < N; l0 += T) {
    const int l = l0 + tid;
    int bit = 0;
    if (l < N) {
      bit = packed_bit(fr.alice, l) ^ (d.num_errors > 0 && keys[l] <= kth);
      fr.tot[l] = bit ? -log_p : log_p;
    }
    const uint32_t w = __ballot_sync(0xffffffffu, bit);
    if ((tid & 31) == 0 && l < N) fr.bob[l >> 5] = w;
  }
  __syncthreads();
}

// The decode of frame f, from its key bits (trial, mc), its frame and LLRs
// (frame) or its LLRs and syndrome (decode), to its statistics or
// decisions.
template <bool LAYERED, bool ADAPTIVE, bool OFFSET, bool MC, int CHECK>
__device__ __forceinline__ void decode_frame(const Params& p, const McDraw& d,
                                             const Frame& fr, int f,
                                             Selection& sel) {
  const int Z = fr.Z, N = fr.N, T = fr.T, tid = fr.tid, z = tid;
  const size_t fo = (size_t)f * N;
  if constexpr (MC) {
    mc_prologue(d, fr, f, sel, p.log_p);
  } else {
    for (int l0 = 0; l0 < N; l0 += T) {  // whole warps
      const int l = l0 + tid;
      const bool in = l < N;
      if (p.mode != kDecode) {
        const uint32_t w =
            __ballot_sync(0xffffffffu, in && (p.alice[fo + l] & 1));
        if ((tid & 31) == 0 && in) fr.alice[l >> 5] = w;
      }
      if (p.mode == kTrial) {
        const bool b = in && p.bob[fo + l] == 1;
        const uint32_t w = __ballot_sync(0xffffffffu, b);
        if ((tid & 31) == 0 && in) fr.bob[l >> 5] = w;
        if (in) fr.tot[l] = b ? -p.log_p : p.log_p;
      } else if (in) {
        fr.tot[l] = p.llr[fo + l];
      }
    }
  }
  __syncthreads();
  // The thread's syndrome bits, one per block-row: from Alice's bits
  // (trial, frame, mc) or the caller's syndrome (decode).
  unsigned long long syn_mask = 0;
  if (z < Z) {
    for (int r = 0; r < p.mb; ++r) {
      int bit = 0;
      if (MC || p.mode != kDecode) {
        for (int e = fr.row_ptr[r]; e < fr.row_ptr[r + 1]; ++e)
          bit ^= packed_bit(fr.alice, edge_bit(fr.ea[e], z, Z));
      } else {
        bit = p.syn[(size_t)f * fr.M + (size_t)r * Z + z] == 1;
      }
      syn_mask |= (unsigned long long)bit << r;
    }
  }
  const int mb = p.mb;
  // Min-sum: every check stored as a message-free one, whose values rebuild
  // as +0 (a -0 pair, negated; +0 where the fill keeps the sign), so that
  // the first sweep's old values need no test.
  if (CHECK == kMinSum && z < Z) {
    const float zero = fr.neg_same ? 0.f : -0.f;
    for (int r = 0; r < mb; ++r) {
      fr.pv[r * Z + z] = make_float2(zero, zero);
      for (int w = 0; w < check_words(p.max_deg); ++w)
        fr.words[(size_t)w * fr.M + r * Z + z] = fr.fill;
    }
  }
  int converged = 0, iters = p.max_iter;
  for (int it = 0; it < p.max_iter; ++it) {
    // Flooding's first sweep reads the channel LLRs unclamped.
    const Bounds msg = bounds(p.use_threshold && it > 0, p);
    if (LAYERED) {
      // The last row's checks leave final totals, so their parity is the
      // sweep's: if one fails, the frame has not converged and the full
      // test is skipped (it would fail there too).
      int last_bad = 0;
      for (int r = 0; r < mb; ++r) {
        if (z < Z)
          last_bad = minsum_check<true, ADAPTIVE, OFFSET>(
              p, fr, r, z, (int)((syn_mask >> r) & 1ull), msg);
        if (r < mb - 1) __syncthreads();
      }
      if (__syncthreads_or(last_bad)) continue;
      int bad = 0;
      if (z < Z)
        for (int r = 0; r < mb - 1; ++r)
          bad |= check_parity(fr, r, z, (int)((syn_mask >> r) & 1ull));
      if (!__syncthreads_or(bad)) {
        converged = 1;
        iters = it + 1;
        break;
      }
      continue;
    }
    // Flooding: the check pass, which also tests the decisions it reads.
    int bad = 0;
    if (z < Z) {
      for (int r = 0; r < mb; ++r) {
        const int sbit = (int)((syn_mask >> r) & 1ull);
        if constexpr (CHECK != kMinSum) {
          bad |= spa_check<CHECK>(fr, r, z, sbit, it, msg);
        } else {
          bad |= minsum_check<false, ADAPTIVE, OFFSET>(p, fr, r, z, sbit, msg);
        }
      }
    }
    // The adaptive pair: converged on the decisions before this sweep. The
    // others: on the decisions of the previous sweep (none before the
    // first). Either way the totals read are kept.
    if (!__syncthreads_or((ADAPTIVE || it > 0) ? bad : 1)) {
      converged = 1;
      iters = ADAPTIVE ? it + 1 : it;
      break;
    }
    if (z < Z) bit_pass<MC, CHECK>(p, fr, fo, z);
    __syncthreads();
  }
  if (!LAYERED && !ADAPTIVE && !converged && p.max_iter > 0) {
    int bad = 0;
    if (z < Z)
      for (int r = 0; r < mb; ++r)
        bad |= check_parity(fr, r, z, (int)((syn_mask >> r) & 1ull));
    if (!__syncthreads_or(bad)) converged = 1;
  }

  if (MC || p.mode != kDecode) {
    int ok = 1;
    for (int l0 = 0; l0 < N; l0 += T) {  // whole warps
      const int l = l0 + tid;
      const uint32_t w = __ballot_sync(0xffffffffu, l < N && fr.tot[l] <= 0.f);
      if ((tid & 31) == 0 && l < N) ok &= w == fr.alice[l >> 5];
    }
    ok = __syncthreads_and(ok);
    if (tid == 0) p.keys[f] = (int8_t)ok;
  } else {
    for (int l = tid; l < N; l += T)
      p.dec_out[fo + l] = fr.tot[l] <= 0.f ? 1 : 0;
  }
  if (tid == 0) {
    p.conv[f] = (int8_t)converged;
    p.iters[f] = iters;
  }
  __syncthreads();  // the next frame overwrites the shared planes
}

// MC: the mc mode (d: what it draws from; unused by the other modes),
// compiled apart so that its prologue's registers do not weigh on the other
// modes. CHECK: the check update (spa.cuh: kMinSum, or the SPA pair, which
// floods). SPA_GLOBAL: the SPA pair's messages in the block's global slice.
template <bool LAYERED, bool ADAPTIVE, bool OFFSET, bool MC, int CHECK,
          bool SPA_GLOBAL>
__global__ void __launch_bounds__(kMaxZ, 1)
    fused_qc_kernel(Params p, McDraw d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SharedLayout lay = shared_layout(p.mb, p.nb, p.z, p.num_be,
                                         p.max_deg, CHECK, SPA_GLOBAL, p.mode);
  const int Z = p.z, mb = p.mb, nb = p.nb, be = p.num_be;
  const int T = blockDim.x, tid = threadIdx.x, M = mb * Z;
  int4* ce = reinterpret_cast<int4*>(smem);
  int2* ea = reinterpret_cast<int2*>(smem + lay.ea);
  int2* eap = reinterpret_cast<int2*>(smem + lay.eap);
  int* row_ptr = reinterpret_cast<int*>(smem + lay.row_ptr);
  int* col_ptr = reinterpret_cast<int*>(smem + lay.col_ptr);
  const int* g_row_ptr = p.table;
  const int* g_cols = p.table + mb + 1;
  const int* g_shifts = g_cols + be;
  const int* g_col_edges = g_shifts + be;
  const int* g_col_ptr = g_col_edges + be;
  for (int e = tid; e < be; e += T) {
    const int s = g_shifts[e];
    ea[e] = make_int2(g_cols[e] * Z + s, Z - s);
    // Column entry: edge | row << 8 | slot << 16 (in column order).
    const int ent = g_col_edges[e], ee = ent & 0xff, row = (ent >> 8) & 0xff;
    const int slot = ent >> 16, se = g_shifts[ee];
    ce[e] = make_int4((CHECK == kMinSum ? row : ee) * Z - se, se,
                      (slot >> 4) * M, 2 * (slot & 15));
  }
  for (int i = tid; i < mb * kRun; i += T) {
    const int r = i / kRun, k = i % kRun, e = g_row_ptr[r] + k;
    eap[i] = e < g_row_ptr[r + 1]
                 ? make_int2(g_cols[e] * Z + g_shifts[e], Z - g_shifts[e])
                 : make_int2(0, Z);
  }
  for (int i = tid; i < mb + 1; i += T) row_ptr[i] = g_row_ptr[i];
  for (int i = tid; i < nb + 1; i += T) col_ptr[i] = g_col_ptr[i];

  Frame fr;
  fr.ea = ea;
  fr.eap = eap;
  fr.ce = ce;
  fr.row_ptr = row_ptr;
  fr.col_ptr = col_ptr;
  fr.tot = reinterpret_cast<float*>(smem + lay.tot);
  fr.pv = reinterpret_cast<float2*>(smem + lay.msgs);
  fr.words = reinterpret_cast<uint32_t*>(smem + lay.words);
  if constexpr (SPA_GLOBAL)
    fr.ext = p.slice + (size_t)blockIdx.x * be * Z;
  else
    fr.ext = reinterpret_cast<float*>(smem + lay.msgs);
  fr.alice = reinterpret_cast<uint32_t*>(smem + lay.alice);
  fr.bob = reinterpret_cast<uint32_t*>(smem + lay.bob);
  fr.Z = Z;
  fr.M = mb * Z;
  fr.N = nb * Z;
  fr.T = T;
  fr.tid = tid;
  fr.neg_same = p.use_threshold && p.threshold < 0.f;
  fr.fill = fr.neg_same ? 0x55555555u : 0u;
  fr.values = bounds(p.use_threshold, p);
  Selection& sel = *reinterpret_cast<Selection*>(smem + lay.msgs);
  __syncthreads();

  for (int f = blockIdx.x; f < p.batch; f += gridDim.x)
    decode_frame<LAYERED, ADAPTIVE, OFFSET, MC, CHECK>(p, d, fr, f, sel);
}

typedef void (*KernelFn)(Params, McDraw);

// flags: bit 0 layered, bit 1 adaptive, bit 2 offset (OMSA/AOMSA), bits 3-4
// the check update (8 SPA, 16 SPA-lin; flooding, neither adaptive nor
// offset), bit 5 (kSpaGlobal) the SPA pair's messages in global memory.
// nullptr for flags without a kernel.
template <bool MC>
KernelFn kernel_of(int flags) {
  const int check = (flags >> 3) & 3;
  const bool global = (flags & kSpaGlobal) != 0;
  if ((flags & ~63) != 0) return nullptr;
  if (check != kMinSum) {
    if ((flags & 7) != 0) return nullptr;
    if (check == kSpa)
      return global ? fused_qc_kernel<false, false, false, MC, kSpa, true>
                    : fused_qc_kernel<false, false, false, MC, kSpa, false>;
    if (check == kSpaLin)
      return global ? fused_qc_kernel<false, false, false, MC, kSpaLin, true>
                    : fused_qc_kernel<false, false, false, MC, kSpaLin, false>;
    return nullptr;
  }
  if (global) return nullptr;
  switch (flags & 7) {
    case 0: return fused_qc_kernel<false, false, false, MC, kMinSum, false>;
    case 1: return fused_qc_kernel<true, false, false, MC, kMinSum, false>;
    case 2: return fused_qc_kernel<false, true, false, MC, kMinSum, false>;
    case 3: return fused_qc_kernel<true, true, false, MC, kMinSum, false>;
    case 4: return fused_qc_kernel<false, false, true, MC, kMinSum, false>;
    case 5: return fused_qc_kernel<true, false, true, MC, kMinSum, false>;
    case 6: return fused_qc_kernel<false, true, true, MC, kMinSum, false>;
    default: return fused_qc_kernel<true, true, true, MC, kMinSum, false>;
  }
}

KernelFn kernel_for(int flags, int mode) {
  return mode == kMc ? kernel_of<true>(flags) : kernel_of<false>(flags);
}

bool shape_ok(int mb, int nb, int z, int num_be, int max_deg) {
  return z >= 1 && z <= kMaxZ && num_be >= 1 && num_be <= kMaxBlockEdges &&
         mb >= 1 && mb <= kMaxBaseChecks && nb >= 1 && max_deg >= 1 &&
         max_deg <= num_be && (long long)nb * z < (1 << 24);
}

size_t shared_bytes(int mb, int nb, int z, int num_be, int max_deg, int flags,
                    int mode) {
  return shared_layout(mb, nb, z, num_be, max_deg, (flags >> 3) & 3,
                       (flags & kSpaGlobal) != 0, mode)
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

int launch(const Params& p, int flags, int grid, cudaStream_t stream,
           const McDraw& d = McDraw{}) {
  const bool global = (flags & kSpaGlobal) != 0;
  if (!shape_ok(p.mb, p.nb, p.z, p.num_be, p.max_deg) || p.batch < 1 ||
      grid < 1 || grid > p.batch || (global && p.slice == nullptr) ||
      (!global && grid != p.batch))
    return (int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags, p.mode);
  const size_t smem =
      shared_bytes(p.mb, p.nb, p.z, p.num_be, p.max_deg, flags, p.mode);
  int err = configure(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads_for(p.z), smem, stream>>>(p, d);
  return (int)cudaGetLastError();
}

Params base_params(int batch, const int32_t* table, int mb, int nb, int z,
                   int num_be, int max_deg, int use_threshold, int max_iter,
                   int mode, float primary, float secondary, float threshold,
                   float* slice, int8_t* conv, int32_t* iters) {
  Params p{};
  p.table = table;
  p.slice = slice;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
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

// Limits the wrapper checks before a launch.
int fused_qc_max_lifting() { return kMaxZ; }
int fused_qc_max_block_edges() { return kMaxBlockEdges; }
int fused_qc_max_base_checks() { return kMaxBaseChecks; }

// The layout the wrapper's plan mirrors (ops/fused_qc.py::launch_plan):
// threads and shared bytes of one block (mode 0 decode, 1 trial, 2 frame,
// 3 mc; flags as the launch's).
int fused_qc_threads(int z) { return threads_for(z); }

long long fused_qc_shared_bytes(int mb, int nb, int z, int num_be,
                                int max_deg, int flags, int mode) {
  return (long long)shared_bytes(mb, nb, z, num_be, max_deg, flags, mode);
}

// Blocks of this configuration that fit on the current device at once, or
// a negative CUDA error.
int fused_qc_resident_blocks(int mb, int nb, int z, int num_be, int max_deg,
                             int flags, int mode) {
  if (!shape_ok(mb, nb, z, num_be, max_deg) || mode < kDecode || mode > kMc)
    return -(int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags, mode);
  const size_t smem = shared_bytes(mb, nb, z, num_be, max_deg, flags, mode);
  int err = configure(kernel, smem);
  if (err != 0) return -err;
  int per_sm = 0, device = 0, sms = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads_for(z), smem);
  if (err == 0) err = (int)cudaGetDevice(&device);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (err != 0) return -err;
  return per_sm * sms;
}

// Bytes of the mc mode's selection state in shared memory.
int mc_selection_bytes() { return (int)sizeof(Selection); }

int fused_qc_trial(const int8_t* alice, const int8_t* bob, int batch,
                   const int32_t* table, int mb, int nb, int z, int num_be,
                   int max_deg, int flags, int use_threshold, int max_iter,
                   float log_p, float primary, float secondary,
                   float threshold, float* slice, int grid, int8_t* conv,
                   int8_t* keys, int32_t* iters, void* stream) {
  Params p = base_params(batch, table, mb, nb, z, num_be, max_deg,
                         use_threshold, max_iter, kTrial, primary, secondary,
                         threshold, slice, conv, iters);
  p.alice = alice;
  p.bob = bob;
  p.log_p = log_p;
  p.keys = keys;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream));
}

int fused_qc_decode(const float* llr, const int8_t* syn, int batch,
                    const int32_t* table, int mb, int nb, int z, int num_be,
                    int max_deg, int flags, int use_threshold, int max_iter,
                    float primary, float secondary, float threshold,
                    float* slice, int grid, int8_t* dec, int8_t* conv,
                    int32_t* iters, void* stream) {
  Params p = base_params(batch, table, mb, nb, z, num_be, max_deg,
                         use_threshold, max_iter, kDecode, primary, secondary,
                         threshold, slice, conv, iters);
  p.llr = llr;
  p.syn = syn;
  p.dec_out = dec;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream));
}

int fused_qc_frame(const int8_t* alice, const float* llr, int batch,
                   const int32_t* table, int mb, int nb, int z, int num_be,
                   int max_deg, int flags, int use_threshold, int max_iter,
                   float primary, float secondary, float threshold,
                   float* slice, int grid, int8_t* conv, int8_t* keys,
                   int32_t* iters, void* stream) {
  Params p = base_params(batch, table, mb, nb, z, num_be, max_deg,
                         use_threshold, max_iter, kFrame, primary, secondary,
                         threshold, slice, conv, iters);
  p.alice = alice;
  p.llr = llr;
  p.keys = keys;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream));
}

int fused_qc_mc(unsigned k0, unsigned k1, int frame0, int num_errors,
                int batch, const int32_t* table, int mb, int nb, int z,
                int num_be, int max_deg, int flags, int use_threshold,
                int max_iter, float log_p, float primary, float secondary,
                float threshold, float* slice, int grid, int8_t* conv,
                int8_t* keys, int32_t* iters, void* stream) {
  Params p = base_params(batch, table, mb, nb, z, num_be, max_deg,
                         use_threshold, max_iter, kMc, primary, secondary,
                         threshold, slice, conv, iters);
  p.log_p = log_p;
  p.keys = keys;
  const McDraw d{McKey{k0, k1}, frame0, num_errors,
                 mc_idx_bits((long long)nb * z)};
  if (num_errors < 0 || (long long)num_errors > (long long)nb * z ||
      frame0 < 0)
    return (int)cudaErrorInvalidValue;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream), d);
}

}  // extern "C"
