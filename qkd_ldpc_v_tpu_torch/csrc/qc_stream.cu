// Streamed QC-LDPC decoder for Hopper (sm_90a): one thread-block cluster
// decodes one frame at a time, with the frame's bit totals spread over the
// cluster's shared memory and its check->bit messages in a global slice of
// its own, from raw keys (trial mode), from LLRs and a syndrome (decode mode)
// or from keys it draws itself (mc mode) to its per-frame statistics or
// decisions.
//
// Replaces the TPU kernel
// qkd_ldpc_v_tpu/ops/pallas_qc_stream.py::_build.kernel (trial, decode and
// mc modes; the min-sum family NMSA/OMSA/ANMSA/AOMSA on the flooding and
// layered schedules; the SPA pair SPA / SPA-lin-approx on the flooding
// schedule, with the check update of csrc/spa.cuh). The mc mode draws
// Alice's keys and the error sort keys from the chunk's Philox stream
// (philox.cuh); the plain version of its keys is ops/channel.py::mc_channel.
// It serves the QC codes whose per-frame state does not fit in one block's
// shared memory (csrc/fused_qc.cu's limit), e.g. every N=102400 asset. The
// plain torch versions it is held to, bit for bit, are in
// qkd_ldpc_v_tpu_torch/ops/qc_decoder.py; they equal the fused QC kernel, so
// the two kernels give the same results wherever both run.
//
// Circulant convention: check-aligned index z of block edge (r, c, s) is
// bit (c, (z + s) mod Z).
//
// Design.
//   * A cluster of C CTAs (C in 1, 2, 4, 8, 16, at most nb: the smallest
//     whose per-CTA share fits in 227 KB; ops/qc_stream.py::plan_for_shape
//     chooses it, and shared_layout below is its mirror) decodes one frame.
//     Bit j lives in CTA j / S, at local index j % S, S = N / C rounded up
//     to 32 (S >= Z, so a base column spans at most two CTAs); each CTA holds
//     its share of the f32 totals, of Alice's and Bob's key bits (packed,
//     trial and mc), the tables and, per thread, the syndrome bits of the
//     checks it owns. Totals are read and (layered) written through
//     distributed shared memory: the prologue turns each block edge into the
//     two shared::cluster addresses its column's totals start at (Tables),
//     so an edge's total is one select and one add away. A persistent grid
//     of as many clusters as fit at once (cudaOccupancyMaxActiveClusters)
//     walks the frames: cluster k decodes frames k, k + clusters, ...
//   * Thread g = rank * T + tid of the cluster owns checks z = g, g + C T,
//     ... of every block-row, T = min(1024, ceil(Z / C) rounded up to 32).
//   * Min-sum messages are stored compressed per check in the cluster's
//     global slice: a plane of value pairs (p1, p2), the clamped check->bit
//     values of an edge whose message is positive with |m| != min1 and with
//     |m| == min1, then W word planes of two bits per edge (m > 0, |m| ==
//     min1), W = ceil(2 * max row degree / 32). The value depends on an
//     edge's message only through those two bits, and an edge with m <= 0
//     takes the exact negation (-p), so stored_value rebuilds every stored
//     value bit for bit (a NaN's sign aside, which no decision reads): 12
//     bytes per check of degree <= 16, where f32 extrinsics take 4 per edge.
//     The SPA pair has no two-minimum form and keeps f32 extrinsics
//     (num_be * Z) in the slice.
//   * Flooding is a check pass then a bit pass. The check pass reads the
//     totals and the old compressed check, and writes the new one; the bit
//     pass forms each local bit's total as ((llr + e_r0) + e_r1) + ... over
//     its column's edges in base-row order from the stored values (the
//     plain decode_flooding's order), so no accumulator plane exists. The
//     convergence test rides in the next check pass, which reads the same
//     totals: if every check holds (from the second sweep on) the frame
//     stops with iters = it and those totals, and the pass's messages are
//     dropped; one parity-only pass follows the last sweep. The adaptive
//     pair tests the decisions at the top of each sweep, as before. Layered
//     keeps block-rows in storage order with a cluster barrier between rows
//     (a circulant maps the distinct checks of a row to distinct bits, so a
//     row needs no atomics); the last row's checks see final totals, so the
//     full parity test runs only where all of them hold.
//   * A check of at most kRun edges loads all its totals before using any
//     (the loads are in flight together) and keeps them, or its messages,
//     in registers; a column of at most kColRun edges loads its stored
//     values together, and the bit pass forms two bits at a time. Longer
//     rows (the R=0.92 code's 50) take two passes over their edges.
//   * Exactness: -fmad=false, no fast math and no flush-to-zero; min.NaN /
//     max.NaN; the first flooding sweep's channel messages unclamped;
//     layered writes t + (val - E); the channel LLR formed from Bob's bit in
//     trial and mc modes (never stored); a per-frame exit on a cluster-wide
//     vote, which equals the plain versions' frozen decisions.
//   * The mc prologue writes Alice's bits and the error sort keys of each
//     CTA's share, the keys in the totals' space (free until the decode
//     starts); every CTA then runs kth_smallest over the whole cluster's
//     keys through distributed shared memory and reaches the same k-th key.
//
// What bounds it on this card. Every committed N=102400 asset takes C = 2
// (the flagship: 1024 threads and about 222 KB a CTA in mc mode, 66
// clusters in flight; the Z=1024 codes 512 threads; the R=0.36 code, with
// 64 base rows, 231,792 bytes, 656 under the limit), and the N <= 10240
// codes C = 1. HBM carries
// only the keys (trial: 2 bytes per bit) or nothing (mc). Per edge and
// iteration a layered sweep reads and writes one total in shared memory
// (half of them in the other CTA), and per check it reads and writes 12
// bytes of compressed check in L2; flooding reads each total once in the
// check pass and 12 bytes per edge of stored values in the bit pass. At 66
// clusters the flagship's slices (0.37 MB a frame) stay in the 50 MB L2;
// those of the R=0.50 and R=0.36 codes (0.61 and 0.79 MB) do not. What
// binds is the instruction throughput and latency of the check update: one
// CTA of 1024 threads per SM (shared memory allows no second), 64 registers
// a thread, about 40 instructions per edge, a cluster barrier per block-row
// (its release fence costs about 0.5 us a row), and in flooding a bit pass
// that reads 12 bytes of stored values per edge from L2. The SPA pair's
// extrinsics (1.2 MB per flagship frame) still stream from HBM. PERF.md has
// the measured chunk times beside their bounds.

#include <cfloat>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "spa.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLifting = 32768;
constexpr int kMaxBlockEdges = 1024;
constexpr int kMaxBaseChecks = 1024;
// Base columns of a code (the 13-bit column field of Tables::cols).
constexpr int kMaxBaseBits = 8191;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
// Checks of at most kRun edges (one word of edge bits) keep their messages
// in registers; longer ones take two passes over their edges.
constexpr int kRun = 12;
// Columns of at most kColRun edges load their stored checks together.
constexpr int kColRun = 4;

// What a launch decodes: LLRs and a syndrome, raw keys, or keys it draws.
enum Mode { kDecode = 0, kTrial = 1, kMc = 2 };

struct Params {
  const int8_t* alice;    // trial: [B, N] 0/1
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr;       // decode: [B, N]
  const int8_t* syn;      // decode: [B, M] 0/1
  const int32_t* table;   // see table_ints
  uint32_t* scratch;      // [clusters, per_cluster] words
  long long per_cluster;  // scratch words per cluster
  int mb, nb, z, num_be, max_deg, cluster, batch, max_iter, use_threshold,
      mode;
  float log_p, primary, secondary, threshold;
  int8_t* dec_out;        // decode: [B, N]
  int8_t* conv;           // [B]
  int8_t* keys;           // trial, mc: [B]
  int32_t* iters;         // [B]
};

// f32 min and max that return NaN where either operand is NaN, as
// torch.minimum / torch.maximum and XLA do (fminf / fmaxf would drop it).
// Rate-adapted LLRs carry the float32 maximum on shortened bits, so sums
// can overflow to inf and inf - inf gives NaN.
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

__device__ __forceinline__ float clamp_msg(float x, const Params& p) {
  return p.use_threshold ? min_nan(max_nan(x, -p.threshold), p.threshold) : x;
}

// Bit->check message of one edge from its total t and old extrinsic eo.
template <bool LAYERED>
__device__ __forceinline__ float message(float t, float eo, int it,
                                         const Params& p) {
  if (LAYERED) return t - eo;
  return it == 0 ? t : clamp_msg(t - eo, p);
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
// Layout (mirrored by ops/qc_stream.py::plan_for_shape).
// ---------------------------------------------------------------------------

// The caller's table (global memory): row_ptr[mb + 1], cols[num_be],
// shifts[num_be] (storage order), col_edges[num_be] (per column, its edges
// in base-row order, each as row | edge << 10 | slot << 20, the slot being
// the edge's index in its row) and col_ptr[nb + 1] as 16-bit halves (edge
// counts stay below kMaxBlockEdges), so that codes of thousands of base
// columns keep the table small.
__host__ __device__ inline int table_ints(int mb, int nb, int num_be) {
  return mb + 1 + 3 * num_be + (nb + 2) / 2;
}

// The table a CTA keeps in shared memory (Tables): per block edge the two
// totals addresses and the packed shift and split (in place of cols and
// shifts), then col_edges, row_ptr and col_ptr.
__host__ __device__ inline int shared_table_ints(int mb, int nb, int num_be) {
  return table_ints(mb, nb, num_be) + num_be;
}

__host__ __device__ inline int threads_for(int z, int cluster) {
  const int per = (z + cluster - 1) / cluster;
  const int t = (per + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Bits of the frame a CTA holds: N / C rounded up to 32.
__host__ __device__ inline int share_bits(long long n, int cluster) {
  return (int)(((n + cluster - 1) / cluster + 31) / 32 * 32);
}

// Words of one compressed check: two bits per edge.
__host__ __device__ inline int check_words(int max_deg) {
  return (2 * max_deg + 31) / 32;
}

// Syndrome words of one thread: its checks' bits, row-major over
// (row, its k-th check of the row).
__host__ __device__ inline int syn_words(int mb, int z, int cluster,
                                         int threads) {
  const int span = cluster * threads;
  const int per_row = (z + span - 1) / span;
  return (mb * per_row + 31) / 32;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of one CTA's shared memory: the table, the votes, the mc
// selection, the syndrome words, the totals, Alice's and Bob's bits.
struct SharedLayout {
  size_t votes, selection, syn, totals, alice, bob, bytes;
};

__host__ __device__ inline SharedLayout shared_layout(int mb, int nb, int z,
                                                      int num_be, int cluster,
                                                      int mode) {
  SharedLayout s;
  const int threads = threads_for(z, cluster);
  const int share = share_bits((long long)nb * z, cluster);
  s.votes = align16(sizeof(int) * shared_table_ints(mb, nb, num_be));
  s.selection = s.votes + align16(sizeof(int) * 2 * kMaxCluster);
  s.syn = s.selection + (mode == kMc ? align16(sizeof(Selection)) : 0);
  s.totals = s.syn + align16(sizeof(uint32_t) * threads *
                             syn_words(mb, z, cluster, threads));
  s.alice = s.totals + sizeof(float) * share;
  const size_t bits = mode == kDecode ? 0 : (size_t)share / 8;
  s.bob = s.alice + bits;
  s.bytes = s.bob + bits;
  return s;
}

// Scratch words of one cluster: the compressed checks (min1, min2 and the
// W-word planes) for the min-sum family, f32 extrinsics for the SPA pair.
__host__ __device__ inline long long scratch_words(int mb, int z, int num_be,
                                                   int max_deg, bool spa) {
  const long long m = (long long)mb * z;
  const long long words =
      spa ? (long long)num_be * z : (2 + check_words(max_deg)) * m;
  return (words + 31) / 32 * 32;  // 128-byte aligned slices
}

// ---------------------------------------------------------------------------
// One CTA's view of its cluster.
// ---------------------------------------------------------------------------

// A CTA's tables (shared memory, built by the kernel's prologue), and the
// caller's cols and shifts (global memory, for the per-frame syndrome).
// S >= Z, so the bits of a base column lie in at most two CTAs: r0, which
// holds its first bit, and r0 + 1 from in-column offset `split` on.
struct Tables {
  // Per block edge: the shared::cluster address that the total of in-column
  // offset jj is 4 jj beyond, in CTA r0 (x) and in CTA r0 + 1 (y).
  const uint2* ab;
  const uint32_t* sp;         // per block edge: shift | (split - 1) << 16
  const uint32_t* col_edges;  // row | edge << 10 | slot << 20
  const int* row_ptr;
  const uint16_t* col_ptr;
  const int* g_cols;
  const int* g_shifts;
};

struct Cta {
  int rank, C, S, T, tid, span, g, count, per_row, n;
  float inv_s;      // 1 / S
  bool neg_same;    // the clamp maps every value to the (negative) threshold
  float* tot;       // [S] this CTA's totals (mc prologue: its sort keys)
  uint32_t win_hi;  // the upper word of generic shared-memory pointers
  uint32_t* alice;  // [S / 32] Alice's bits of this CTA's share
  uint32_t* bob;    // [S / 32] Bob's bits
  uint32_t* syn;    // [words][T] the syndrome bits of each thread's checks
  int* votes;       // [2][kMaxCluster]
  int vote_slot;
};

template <typename T>
__device__ __forceinline__ T* remote(const Cta& c, T* local, int rank) {
  return cg::this_cluster().map_shared_rank(local, (unsigned)rank);
}

// The total of block edge e at check z: its shared::cluster address (ab,
// sp) in the generic window whose upper word is win_hi, the upper word of
// every shared-memory pointer (the compiler's own lowering of
// ld.shared::cluster rebuilds it with a special-register read per access).
__device__ __forceinline__ uint32_t edge_total(const Tables& tb, int e,
                                               int z, int Z) {
  const uint32_t sp = tb.sp[e];
  const uint2 ab = tb.ab[e];
  int jj = z + (int)(sp & 0xffffu);
  if (jj >= Z) jj -= Z;
  return (jj > (int)(sp >> 16) ? ab.y : ab.x) + 4u * (uint32_t)jj;
}

// The total at shared::cluster address a (kept as 32 bits in registers).
__device__ __forceinline__ float& total(const Cta& c, uint32_t a) {
  return *reinterpret_cast<float*>((uint64_t)c.win_hi << 32 | a);
}

__device__ __forceinline__ int local_bit(const uint32_t* bits, int l) {
  return (bits[l >> 5] >> (l & 31)) & 1;
}

// Alice's bit of block edge e at check z, wherever it lives (per frame, so
// from the caller's table).
__device__ __forceinline__ int alice_bit(const Cta& c, const Tables& tb,
                                         int e, int z, int Z) {
  int jj = z + __ldg(tb.g_shifts + e);
  if (jj >= Z) jj -= Z;
  const int j = __ldg(tb.g_cols + e) * Z + jj;
  // j / S from a float estimate, off by at most one (j < 2**24).
  int rank = __float2int_rz(__int2float_rn(j) * c.inv_s);
  if (rank * c.S > j) --rank;
  else if ((rank + 1) * c.S <= j) ++rank;
  return local_bit(remote(c, c.alice, rank), j - rank * c.S);
}

// The OR of v over every thread of the cluster; a cluster barrier.
__device__ int cluster_or(Cta& c, int v) {
  const int any = __syncthreads_or(v);
  int* slot = c.votes + c.vote_slot * kMaxCluster;
  if (c.tid == 0)
    for (int k = 0; k < c.C; ++k) remote(c, slot, k)[c.rank] = any;
  cg::this_cluster().sync();
  int out = 0;
  for (int k = 0; k < c.C; ++k) out |= slot[k];
  c.vote_slot ^= 1;
  return out;
}

// The channel LLR of frame bit j (local index l of this CTA): +-log_p from
// Bob's bit (trial and mc), or the caller's LLR (decode).
__device__ __forceinline__ float channel_llr(const Params& p, const Cta& c,
                                             size_t fo, int j, int l) {
  if (p.mode != kDecode) return local_bit(c.bob, l) ? -p.log_p : p.log_p;
  return p.llr[fo + j];
}

// The syndrome bit of the thread's check k (row-major over its checks).
__device__ __forceinline__ int syn_bit(const Cta& c, int k) {
  return (c.syn[(k >> 5) * c.T + c.tid] >> (k & 31)) & 1;
}

// ---------------------------------------------------------------------------
// Compressed min-sum checks: a plane of value pairs, then W word planes. A
// check stores (p1, p2), its clamped check->bit values for an edge whose
// message is positive with |m| != min1 and with |m| == min1 (minsum_from
// with excl = 1), and per edge k bit 2k (m > 0) and bit 2k + 1 (|m| ==
// min1). An edge with m <= 0 takes -p: f * row_sign * -1 * eabs and
// clamp(-x) are the exact negations, unless the clamp's threshold is
// negative, where every clamped value is the threshold itself (neg_same).
// Planes are read through L2 (ld.global.cg), never a stale L1 line of
// another CTA's write.
// ---------------------------------------------------------------------------

struct Planes {
  float2* pv;
  uint32_t* words;
  size_t m;  // checks per plane
};

__device__ __forceinline__ Planes planes_of(const Params& p, uint32_t* base) {
  const size_t m = (size_t)p.mb * p.z;
  return Planes{reinterpret_cast<float2*>(base), base + 2 * m, m};
}

// The check->bit value of slot k of a stored check (its pair pv, and w the
// word that holds slot k).
__device__ __forceinline__ float stored_value(const Cta& c, float2 pv,
                                              uint32_t w, int k) {
  const uint32_t b = w >> ((2 * k) & 31);
  const float v = b & 2u ? pv.y : pv.x;
  return (b & 1u) || c.neg_same ? v : -v;
}

// The stored pair of a new check.
template <bool OFFSET>
__device__ __forceinline__ float2 new_values(const Params& p, float min1,
                                             float min2, float row_sign,
                                             float f) {
  return make_float2(
      clamp_msg(minsum_from<OFFSET>(1.f, min1, row_sign, f), p),
      clamp_msg(minsum_from<OFFSET>(1.f, min2, row_sign, f), p));
}

// The running two minima, sign count and decision parity of a check.
struct TwoMin {
  float min1 = 0.f, min2 = FLT_MAX;
  int neg = 0, par;
  __device__ void add(int k, float t, float mm) {
    const float av = fabsf(mm);
    if (k == 0) {
      min1 = av;
    } else {
      min2 = min_nan(min2, max_nan(min1, av));
      min1 = min_nan(min1, av);
    }
    neg += mm < 0.f;
    par ^= t <= 0.f;
  }
};

// One min-sum check (row r, index z, syndrome bit sbit) of sweep `it`: the
// two minima, the sign parity and the decision parity over its edges, then
// the new edge bits and (layered) the totals t + (val - E). Checks of at
// most kRun edges keep their totals (or messages) in registers, with every
// total in flight at once; longer ones take two passes over their edges.
// Writes the check's new compressed form. Returns the decision parity (1:
// unsatisfied) of the totals it read (flooding) or of those it leaves
// (layered).
template <bool LAYERED, bool ADAPTIVE, bool OFFSET>
__device__ int minsum_check(const Params& p, const Cta& c, const Tables& tb,
                            const Planes& pl, int r, int z, int sbit,
                            int it) {
  const int Z = p.z, b = tb.row_ptr[r], deg = tb.row_ptr[r + 1] - b;
  const size_t q = (size_t)r * Z + z;
  const float2 old = it ? __ldcg(pl.pv + q) : make_float2(0.f, 0.f);
  TwoMin tm;
  tm.par = sbit;
  int left = sbit;  // layered: the parity of the totals it leaves
  if (deg <= kRun) {
    // Flooding keeps the messages for the second loop; layered keeps the
    // totals, and forms each message t - E again from the same operands
    // and each address again (kept, the addresses spill at 64 registers).
    const uint32_t ow = it ? __ldcg(pl.words + q) : 0u;
    float t[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < deg) t[k] = total(c, edge_total(tb, b + k, z, Z));
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < deg) {
        const float eo = it ? stored_value(c, old, ow, k) : 0.f;
        const float mm = message<LAYERED>(t[k], eo, it, p);
        tm.add(k, t[k], mm);
        if (!LAYERED) t[k] = mm;
      }
    }
    const float row_sign =
        (sbit ? -1.f : 1.f) * ((tm.neg & 1) == 0 ? 1.f : -1.f);
    const float fac = (ADAPTIVE && tm.par) ? p.secondary : p.primary;
    const float2 nv = new_values<OFFSET>(p, tm.min1, tm.min2, row_sign, fac);
    uint32_t nw = 0u;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < deg) {
        const float eo =
            LAYERED && it ? stored_value(c, old, ow, k) : 0.f;
        const float mm = LAYERED ? message<true>(t[k], eo, it, p) : t[k];
        const uint32_t bits =
            (mm > 0.f ? 1u : 0u) | (fabsf(mm) == tm.min1 ? 2u : 0u);
        nw |= bits << (2 * k);
        if (LAYERED) {
          const float tn = t[k] + (stored_value(c, nv, bits, 0) - eo);
          total(c, edge_total(tb, b + k, z, Z)) = tn;
          left ^= tn <= 0.f;
        }
      }
    }
    pl.words[q] = nw;
    pl.pv[q] = nv;
    return LAYERED ? left : tm.par;
  }
  // Long checks: the words of the old form are streamed slot by slot, each
  // loaded once and before the new form overwrites it.
  uint32_t ow = 0u;
  int ow_idx = -1;
  auto old_value = [&](int k) {
    const int wi = (2 * k) >> 5;
    if (wi != ow_idx) {
      ow = __ldcg(pl.words + (size_t)wi * pl.m + q);
      ow_idx = wi;
    }
    return stored_value(c, old, ow, k);
  };
  for (int k = 0; k < deg; ++k) {
    const float t = total(c, edge_total(tb, b + k, z, Z));
    const float eo = it ? old_value(k) : 0.f;
    tm.add(k, t, message<LAYERED>(t, eo, it, p));
  }
  const float row_sign =
      (sbit ? -1.f : 1.f) * ((tm.neg & 1) == 0 ? 1.f : -1.f);
  const float fac = (ADAPTIVE && tm.par) ? p.secondary : p.primary;
  const float2 nv = new_values<OFFSET>(p, tm.min1, tm.min2, row_sign, fac);
  uint32_t nw = 0u;
  ow_idx = -1;
  for (int k = 0; k < deg; ++k) {
    const uint32_t a = edge_total(tb, b + k, z, Z);
    const float t = total(c, a);
    const float eo = it ? old_value(k) : 0.f;
    const float mm = message<LAYERED>(t, eo, it, p);
    const uint32_t bits =
        (mm > 0.f ? 1u : 0u) | (fabsf(mm) == tm.min1 ? 2u : 0u);
    nw |= bits << ((2 * k) & 31);
    if (LAYERED) {
      const float tn = t + (stored_value(c, nv, bits, 0) - eo);
      total(c, a) = tn;
      left ^= tn <= 0.f;
    }
    if (((2 * k) & 31) == 30 || k == deg - 1) {
      pl.words[(size_t)((2 * k) >> 5) * pl.m + q] = nw;
      nw = 0u;
    }
  }
  pl.pv[q] = nv;
  return LAYERED ? left : tm.par;
}

// One SPA-pair check (flooding). Checks of at most kRun edges keep their
// terms in registers; longer ones park each term in its edge's extrinsic
// slot until the new extrinsic replaces it (spa_row). Returns the decision
// parity of the totals it read.
template <int CHECK>
__device__ int spa_check(const Params& p, const Cta& c, const Tables& tb,
                         float* ext, int r, int z, int sbit, int it) {
  const int Z = p.z, b = tb.row_ptr[r], deg = tb.row_ptr[r + 1] - b;
  int par = sbit;
  if (deg <= kRun) {
    float t[kRun], eo[kRun], th[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < deg) {
        t[k] = total(c, edge_total(tb, b + k, z, Z));
        eo[k] = it ? __ldcg(ext + (size_t)(b + k) * Z + z) : 0.f;
      }
    }
    float prod = sbit ? -1.f : 1.f;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < deg) {
        par ^= t[k] <= 0.f;
        th[k] = spa_term<CHECK>(message<false>(t[k], eo[k], it, p));
        prod = prod * th[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < deg)
        ext[(size_t)(b + k) * Z + z] =
            clamp_msg(spa_extrinsic<CHECK>(prod / th[k]), p);
    return par;
  }
  spa_row<CHECK>(
      deg, sbit != 0,
      [&](int k) {
        const int e = b + k;
        const float t = total(c, edge_total(tb, e, z, Z));
        par ^= t <= 0.f;
        const float eo = it ? __ldcg(ext + (size_t)e * Z + z) : 0.f;
        const float th = spa_term<CHECK>(message<false>(t, eo, it, p));
        ext[(size_t)e * Z + z] = th;
        return th;
      },
      [&](int k) { return __ldcg(ext + (size_t)(b + k) * Z + z); },
      [&](int k, float v) { ext[(size_t)(b + k) * Z + z] = clamp_msg(v, p); });
  return par;
}

// The decision parity of one check over the current totals.
__device__ int check_parity(const Params& p, const Cta& c, const Tables& tb,
                            int r, int z, int sbit) {
  int par = sbit;
  const int b = tb.row_ptr[r], deg = tb.row_ptr[r + 1] - b;
  if (deg <= kRun) {  // the loads in flight together
    float t[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < deg) t[k] = total(c, edge_total(tb, b + k, z, p.z));
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < deg) par ^= t[k] <= 0.f;
    return par;
  }
  for (int e = b; e < b + deg; ++e)
    par ^= total(c, edge_total(tb, e, z, p.z)) <= 0.f;
  return par;
}

// Calls f(r, z, k) for every check the thread owns in row r, k its index
// among the thread's checks (the syndrome word bit).
template <typename F>
__device__ __forceinline__ void for_own_checks_in_row(const Params& p,
                                                      const Cta& c, int r,
                                                      F f) {
  for (int i = 0; i < c.per_row; ++i) {
    const int z = c.g + i * c.span;
    if (z < p.z) f(r, z, r * c.per_row + i);
  }
}

// The stored check->bit value of column entry `entry` (row | edge << 10 |
// slot << 20) at in-column offset jj: the word and the value pair load at
// once (no dependent load).
template <int CHECK>
__device__ __forceinline__ float column_value(const Params& p, const Cta& c,
                                              const Tables& tb,
                                              const uint32_t* slice,
                                              const Planes& pl,
                                              uint32_t entry, int jj) {
  const int Z = p.z, e = (int)((entry >> 10) & 0x3ffu);
  int z = jj - (int)(tb.sp[e] & 0xffffu);
  if (z < 0) z += Z;
  if constexpr (CHECK != kMinSum) {
    return __ldcg(reinterpret_cast<const float*>(slice) + (size_t)e * Z + z);
  } else {
    const size_t q = (size_t)(entry & 0x3ffu) * Z + z;
    const int k = (int)(entry >> 20);
    const uint32_t w = __ldcg(pl.words + (size_t)(k >> 4) * pl.m + q);
    return stored_value(c, __ldcg(pl.pv + q), w, k);
  }
}

// The flooding bit pass: each of this CTA's bits takes its total
// ((llr + e_r0) + e_r1) + ... over its column's edges in base-row order,
// from the stored check->bit values. Columns of at most kColRun edges load
// their values before adding any, so the loads are in flight together.
template <int CHECK>
__device__ __forceinline__ float bit_total(const Params& p, const Cta& c,
                                           const Tables& tb,
                                           const uint32_t* slice,
                                           const Planes& pl, size_t fo, int l,
                                           int col, int jj) {
  float total = channel_llr(p, c, fo, c.rank * c.S + l, l);
  const int cb = tb.col_ptr[col], cdeg = tb.col_ptr[col + 1] - cb;
  if (cdeg <= kColRun) {
    float v[kColRun];
#pragma unroll
    for (int i = 0; i < kColRun; ++i)
      if (i < cdeg)
        v[i] = column_value<CHECK>(p, c, tb, slice, pl, tb.col_edges[cb + i],
                                   jj);
#pragma unroll
    for (int i = 0; i < kColRun; ++i)
      if (i < cdeg) total = total + v[i];
  } else {
    for (int i = 0; i < cdeg; ++i)
      total = total + column_value<CHECK>(p, c, tb, slice, pl,
                                          tb.col_edges[cb + i], jj);
  }
  return total;
}

// The flooding bit pass: each of this CTA's bits takes its total
// ((llr + e_r0) + e_r1) + ... over its column's edges in base-row order,
// from the stored check->bit values. Columns of at most kColRun edges load
// their values before adding any, and a thread forms two bits' totals
// before it stores either, so the loads are in flight together.
// Frame bit (col, jj) advanced by T bits (T <= Z).
__device__ __forceinline__ void advance(int& col, int& jj, int T, int Z) {
  jj += T;
  if (jj >= Z) {
    jj -= Z;
    ++col;
  }
}

template <int CHECK>
__device__ void bit_pass(const Params& p, const Cta& c, const Tables& tb,
                         uint32_t* slice, size_t fo) {
  const Planes pl = planes_of(p, slice);
  const int Z = p.z, j0 = c.rank * c.S + c.tid;
  int l = c.tid, col = j0 / Z, jj = j0 - col * Z;
  for (; l + c.T < c.count; l += 2 * c.T) {
    int col1 = col, jj1 = jj;
    advance(col1, jj1, c.T, Z);
    const float t0 = bit_total<CHECK>(p, c, tb, slice, pl, fo, l, col, jj);
    const float t1 =
        bit_total<CHECK>(p, c, tb, slice, pl, fo, l + c.T, col1, jj1);
    c.tot[l] = t0;
    c.tot[l + c.T] = t1;
    col = col1;
    jj = jj1;
    advance(col, jj, c.T, Z);
  }
  if (l < c.count)
    c.tot[l] = bit_total<CHECK>(p, c, tb, slice, pl, fo, l, col, jj);
}

// ---------------------------------------------------------------------------
// Frame set-up: key bits, totals and syndrome words.
// ---------------------------------------------------------------------------

// Packs bit(l) of this CTA's share (0 past N) into words[l / 32]; whole
// warps take part in each ballot (S and T are multiples of 32).
template <typename Bit>
__device__ __forceinline__ void pack_bits(const Cta& c, uint32_t* words,
                                          Bit bit) {
  for (int base = 0; base < c.S; base += c.T) {
    const int l = base + c.tid;
    if (l < c.S) {
      const int v = l < c.count ? bit(l) : 0;
      const uint32_t w = __ballot_sync(0xffffffffu, v);
      if ((c.tid & 31) == 0) words[l >> 5] = w;
    }
  }
}

// The mc mode's keys of chunk frame d.frame0 + f: Alice's bits and the sort
// keys of this CTA's share (the keys in the totals' space), the exact
// selection of the num_errors smallest keys of the whole frame (every CTA
// enumerates every key of the cluster and reaches the same k-th one), and
// Bob's bits. Ends on a cluster barrier, after which the keys are dead.
__device__ void mc_prologue(const Params& p, const McDraw& d, const Cta& c,
                            int f, Selection& sel) {
  const int frame = d.frame0 + f;
  uint32_t* keys = reinterpret_cast<uint32_t*>(c.tot);
  const int j0 = c.rank * c.S;
  pack_bits(c, c.alice,
            [&](int l) { return mc_alice(d.key, j0 + l, frame); });
  for (int l = c.tid; l < c.count; l += c.T)
    keys[l] = mc_sort_key(d.key, j0 + l, frame, d.idx_bits);
  cg::this_cluster().sync();
  uint32_t kth = 0;
  if (d.num_errors > 0)
    kth = kth_smallest(
        [&](auto visit) {
          for (int k = 0; k < c.C; ++k) {
            const int cnt = min(c.S, c.n - k * c.S);
            const uint32_t* kk = remote(c, keys, k);
            for (int l = c.tid; l < cnt; l += c.T) visit(kk[l]);
          }
        },
        d.num_errors, sel);
  pack_bits(c, c.bob, [&](int l) {
    return local_bit(c.alice, l) ^ (d.num_errors > 0 && keys[l] <= kth);
  });
  cg::this_cluster().sync();
}

// The decode of frame f, from its key bits (trial and mc, already packed) or
// its LLRs and syndrome (decode), to its statistics or decisions.
template <bool LAYERED, bool ADAPTIVE, bool OFFSET, int CHECK>
__device__ void decode_frame(const Params& p, Cta& c, const Tables& tb,
                             uint32_t* slice, int f) {
  const int Z = p.z;
  const size_t fo = (size_t)f * c.n, M = (size_t)p.mb * Z;
  for (int l = c.tid; l < c.count; l += c.T)
    c.tot[l] = channel_llr(p, c, fo, c.rank * c.S + l, l);
  // Each thread's syndrome words: from Alice's bits across the cluster
  // (trial, mc) or the caller's syndrome (decode).
  {
    uint32_t word = 0;
    int k_last = -1;
    for (int r = 0; r < p.mb; ++r)
      for_own_checks_in_row(p, c, r, [&](int r, int z, int k) {
        if ((k >> 5) != (k_last >> 5) && k_last >= 0) {
          c.syn[(k_last >> 5) * c.T + c.tid] = word;
          word = 0;
        }
        int bit = 0;
        if (p.mode != kDecode) {
          for (int e = tb.row_ptr[r]; e < tb.row_ptr[r + 1]; ++e)
            bit ^= alice_bit(c, tb, e, z, Z);
        } else {
          bit = p.syn[(size_t)f * M + (size_t)r * Z + z] == 1;
        }
        word |= (uint32_t)bit << (k & 31);
        k_last = k;
      });
    if (k_last >= 0) c.syn[(k_last >> 5) * c.T + c.tid] = word;
  }
  cg::this_cluster().sync();

  const Planes pl = planes_of(p, slice);
  float* ext = reinterpret_cast<float*>(slice);
  int converged = 0, iters = p.max_iter;
  for (int it = 0; it < p.max_iter; ++it) {
    if (LAYERED) {
      // The last row's checks leave final totals, so their parity is the
      // sweep's: if one fails, the frame has not converged and the full
      // test is skipped (it would fail there too).
      int last_bad = 0;
      for (int r = 0; r < p.mb; ++r) {
        for_own_checks_in_row(p, c, r, [&](int r, int z, int k) {
          last_bad |= minsum_check<true, ADAPTIVE, OFFSET>(
              p, c, tb, pl, r, z, syn_bit(c, k), it);
        });
        if (r < p.mb - 1) {
          last_bad = 0;
          cg::this_cluster().sync();
        }
      }
      if (cluster_or(c, last_bad)) continue;
      int bad = 0;
      for (int r = 0; r < p.mb - 1; ++r)
        for_own_checks_in_row(p, c, r, [&](int r, int z, int k) {
          bad |= check_parity(p, c, tb, r, z, syn_bit(c, k));
        });
      if (!cluster_or(c, bad)) {
        converged = 1;
        iters = it + 1;
        break;
      }
      continue;
    }
    // Flooding: the check pass, which also tests the decisions it reads.
    int bad = 0;
    for (int r = 0; r < p.mb; ++r)
      for_own_checks_in_row(p, c, r, [&](int r, int z, int k) {
        if constexpr (CHECK != kMinSum) {
          bad |= spa_check<CHECK>(p, c, tb, ext, r, z, syn_bit(c, k), it);
        } else {
          bad |= minsum_check<false, ADAPTIVE, OFFSET>(p, c, tb, pl, r, z,
                                                       syn_bit(c, k), it);
        }
      });
    // The adaptive pair: converged on the decisions before this sweep. The
    // others: on the decisions of the previous sweep (none before the
    // first). Either way the totals read are kept.
    if (!cluster_or(c, (ADAPTIVE || it > 0) ? bad : 1)) {
      converged = 1;
      iters = ADAPTIVE ? it + 1 : it;
      break;
    }
    bit_pass<CHECK>(p, c, tb, slice, fo);
    cg::this_cluster().sync();
  }
  if (!LAYERED && !ADAPTIVE && !converged && p.max_iter > 0) {
    int bad = 0;
    for (int r = 0; r < p.mb; ++r)
      for_own_checks_in_row(p, c, r, [&](int r, int z, int k) {
        bad |= check_parity(p, c, tb, r, z, syn_bit(c, k));
      });
    if (!cluster_or(c, bad)) converged = 1;
  }

  int ok = 1;
  if (p.mode != kDecode) {
    for (int l = c.tid; l < c.count; l += c.T)
      ok &= (c.tot[l] <= 0.f ? 1 : 0) == local_bit(c.alice, l);
    ok = !cluster_or(c, !ok);
  } else {
    for (int l = c.tid; l < c.count; l += c.T)
      p.dec_out[fo + c.rank * c.S + l] = c.tot[l] <= 0.f ? 1 : 0;
  }
  if (c.rank == 0 && c.tid == 0) {
    if (p.mode != kDecode) p.keys[f] = (int8_t)ok;
    p.conv[f] = (int8_t)converged;
    p.iters[f] = iters;
  }
  cg::this_cluster().sync();  // the next frame overwrites the shares
}

// MC: the mc mode (d: what it draws from; unused by the other modes),
// compiled apart so that its prologue's registers do not weigh on the other
// modes. CHECK: the check update (spa.cuh: kMinSum, or the SPA pair, which
// floods).
template <bool LAYERED, bool ADAPTIVE, bool OFFSET, bool MC, int CHECK>
__global__ void __launch_bounds__(kMaxThreads, 1)
    qc_stream_kernel(Params p, McDraw d) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const SharedLayout lay =
      shared_layout(p.mb, p.nb, p.z, p.num_be, p.cluster, p.mode);
  const int n = p.nb * p.z, S = share_bits(n, p.cluster), be = p.num_be;
  uint2* ab = reinterpret_cast<uint2*>(smem);
  uint32_t* sp = reinterpret_cast<uint32_t*>(ab + be);
  uint32_t* rest = sp + be;  // col_edges, row_ptr, col_ptr: as the caller's
  const int* g_cols = p.table + p.mb + 1;
  const int* g_shifts = g_cols + be;
  const uint32_t tot_sa = (uint32_t)__cvta_generic_to_shared(smem + lay.totals);
  for (int e = threadIdx.x; e < be; e += blockDim.x) {
    const int col0 = g_cols[e] * p.z, r0 = col0 / S;
    const int split = min((r0 + 1) * S - col0, p.z);
    uint32_t x, y;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(x) : "r"(tot_sa), "r"(r0));
    x += 4u * (uint32_t)(col0 - r0 * S);
    y = x;
    if (split < p.z) {
      asm("mapa.shared::cluster.u32 %0, %1, %2;"
          : "=r"(y) : "r"(tot_sa), "r"(r0 + 1));
      y -= 4u * (uint32_t)((r0 + 1) * S - col0);
    }
    ab[e] = make_uint2(x, y);
    sp[e] = (uint32_t)g_shifts[e] | (uint32_t)(split - 1) << 16;
  }
  const int rest_ints = table_ints(p.mb, p.nb, be) - (p.mb + 1 + 2 * be);
  for (int i = threadIdx.x; i < be; i += blockDim.x)
    rest[i] = (uint32_t)g_shifts[be + i];  // col_edges
  for (int i = threadIdx.x; i < rest_ints - be; i += blockDim.x)
    rest[be + i] = (uint32_t)g_shifts[2 * be + i];  // col_ptr
  for (int i = threadIdx.x; i < p.mb + 1; i += blockDim.x)
    rest[rest_ints + i] = (uint32_t)p.table[i];  // row_ptr
  Tables tb;
  tb.ab = ab;
  tb.sp = sp;
  tb.col_edges = rest;
  tb.col_ptr = reinterpret_cast<const uint16_t*>(rest + be);
  tb.row_ptr = reinterpret_cast<const int*>(rest + rest_ints);
  tb.g_cols = g_cols;
  tb.g_shifts = g_shifts;

  Cta c;
  c.rank = (int)cluster.block_rank();
  c.C = p.cluster;
  c.n = n;
  c.S = S;
  c.inv_s = 1.f / (float)S;
  c.neg_same = p.use_threshold && p.threshold < 0.f;
  c.T = blockDim.x;
  c.tid = threadIdx.x;
  c.span = c.C * c.T;
  c.g = c.rank * c.T + c.tid;
  c.count = max(0, min(c.S, c.n - c.rank * c.S));
  c.per_row = (p.z + c.span - 1) / c.span;
  c.tot = reinterpret_cast<float*>(smem + lay.totals);
  c.win_hi = (uint32_t)(reinterpret_cast<uintptr_t>(smem) >> 32);
  c.alice = reinterpret_cast<uint32_t*>(smem + lay.alice);
  c.bob = reinterpret_cast<uint32_t*>(smem + lay.bob);
  c.syn = reinterpret_cast<uint32_t*>(smem + lay.syn);
  c.votes = reinterpret_cast<int*>(smem + lay.votes);
  c.vote_slot = 0;
  Selection& sel = *reinterpret_cast<Selection*>(smem + lay.selection);
  __syncthreads();

  const int cid = blockIdx.x / c.C, clusters = gridDim.x / c.C;
  uint32_t* slice = p.scratch + (size_t)cid * (size_t)p.per_cluster;
  for (int f = cid; f < p.batch; f += clusters) {
    if constexpr (MC) {
      mc_prologue(p, d, c, f, sel);
    } else if (p.mode == kTrial) {
      const size_t fo = (size_t)f * c.n + (size_t)c.rank * c.S;
      pack_bits(c, c.alice, [&](int l) { return p.alice[fo + l] & 1; });
      pack_bits(c, c.bob, [&](int l) { return p.bob[fo + l] == 1; });
      cluster.sync();
    }
    decode_frame<LAYERED, ADAPTIVE, OFFSET, CHECK>(p, c, tb, slice, f);
  }
}

typedef void (*KernelFn)(Params, McDraw);

// flags: bit 0 layered, bit 1 adaptive, bit 2 offset (OMSA/AOMSA), bits 3-4
// the check update (8 SPA, 16 SPA-lin; flooding, neither adaptive nor
// offset). nullptr for flags without a kernel.
template <bool MC>
KernelFn kernel_of(int flags) {
  const int check = (flags >> 3) & 3;
  if (check != kMinSum) {
    if ((flags & 7) != 0) return nullptr;
    if (check == kSpa) return qc_stream_kernel<false, false, false, MC, kSpa>;
    if (check == kSpaLin)
      return qc_stream_kernel<false, false, false, MC, kSpaLin>;
    return nullptr;
  }
  switch (flags & 7) {
    case 0: return qc_stream_kernel<false, false, false, MC, kMinSum>;
    case 1: return qc_stream_kernel<true, false, false, MC, kMinSum>;
    case 2: return qc_stream_kernel<false, true, false, MC, kMinSum>;
    case 3: return qc_stream_kernel<true, true, false, MC, kMinSum>;
    case 4: return qc_stream_kernel<false, false, true, MC, kMinSum>;
    case 5: return qc_stream_kernel<true, false, true, MC, kMinSum>;
    case 6: return qc_stream_kernel<false, true, true, MC, kMinSum>;
    default: return qc_stream_kernel<true, true, true, MC, kMinSum>;
  }
}

KernelFn kernel_for(int flags, bool mc) {
  return mc ? kernel_of<true>(flags) : kernel_of<false>(flags);
}

bool shape_ok(int mb, int nb, int z, int num_be, int max_deg, int cluster) {
  return z >= 1 && z <= kMaxLifting && num_be >= 1 &&
         num_be <= kMaxBlockEdges && mb >= 1 && mb <= kMaxBaseChecks &&
         nb >= 1 && nb <= kMaxBaseBits && (long long)nb * z < (1 << 24) &&
         max_deg >= 1 && max_deg <= num_be && cluster >= 1 &&
         cluster <= kMaxCluster && cluster <= nb &&
         (cluster & (cluster - 1)) == 0;
}

// The launch configuration of one kernel (clusters of `cluster` CTAs, the
// whole shared layout), with the kernel's attributes set for it.
int configure(KernelFn kernel, int mb, int nb, int z, int num_be, int cluster,
              int mode, int grid, cudaStream_t stream, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr) {
  const size_t smem =
      shared_layout(mb, nb, z, num_be, cluster, mode).bytes;
  if (kernel == nullptr || smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != 0) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads_for(z, cluster), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

int launch(const Params& p, int flags, int grid, cudaStream_t stream,
           const McDraw& d = McDraw{}) {
  if (!shape_ok(p.mb, p.nb, p.z, p.num_be, p.max_deg, p.cluster) ||
      p.batch < 1 || grid < p.cluster || grid % p.cluster != 0 ||
      p.scratch == nullptr ||
      p.per_cluster < scratch_words(p.mb, p.z, p.num_be, p.max_deg,
                                    ((flags >> 3) & 3) != kMinSum))
    return (int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags, p.mode == kMc);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure(kernel, p.mb, p.nb, p.z, p.num_be, p.cluster, p.mode,
                      grid, stream, cfg, attr);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, p, d);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch.
int qc_stream_max_lifting() { return kMaxLifting; }
int qc_stream_max_block_edges() { return kMaxBlockEdges; }
int qc_stream_max_base_checks() { return kMaxBaseChecks; }
int qc_stream_max_base_bits() { return kMaxBaseBits; }
int qc_stream_max_cluster() { return kMaxCluster; }

// The layout the wrapper's plan mirrors (ops/qc_stream.py::plan_for_shape):
// one CTA's threads and shared bytes (mode 0 decode, 1 trial, 2 mc), and
// one cluster's scratch words (flags as the launch's).
int qc_stream_threads(int z, int cluster) { return threads_for(z, cluster); }

long long qc_stream_shared_bytes(int mb, int nb, int z, int num_be,
                                 int cluster, int mode) {
  return (long long)shared_layout(mb, nb, z, num_be, cluster, mode).bytes;
}

long long qc_stream_scratch_words(int mb, int z, int num_be, int max_deg,
                                  int flags) {
  return scratch_words(mb, z, num_be, max_deg, ((flags >> 3) & 3) != kMinSum);
}

// Clusters of `cluster` CTAs of this configuration that fit on the current
// device at once, or a negative CUDA error.
int qc_stream_resident_clusters(int mb, int nb, int z, int num_be, int flags,
                                int mode, int cluster) {
  if (!shape_ok(mb, nb, z, num_be, 1, cluster))
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  KernelFn kernel = kernel_for(flags, mode == kMc);
  int err = configure(kernel, mb, nb, z, num_be, cluster, mode, cluster,
                      nullptr, cfg, attr);
  if (err != 0) return -err;
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != 0) return -err;
  return clusters;
}

int qc_stream_trial(const int8_t* alice, const int8_t* bob, int batch,
                    const int32_t* table, int mb, int nb, int z, int num_be,
                    int max_deg, int flags, int use_threshold, int max_iter,
                    float log_p, float primary, float secondary,
                    float threshold, uint32_t* scratch, long long per_cluster,
                    int cluster, int grid, int8_t* conv, int8_t* keys,
                    int32_t* iters, void* stream) {
  Params p{};
  p.alice = alice;
  p.bob = bob;
  p.table = table;
  p.scratch = scratch;
  p.per_cluster = per_cluster;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
  p.max_deg = max_deg;
  p.cluster = cluster;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = kTrial;
  p.log_p = log_p;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.conv = conv;
  p.keys = keys;
  p.iters = iters;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream));
}

int qc_stream_decode(const float* llr, const int8_t* syn, int batch,
                     const int32_t* table, int mb, int nb, int z, int num_be,
                     int max_deg, int flags, int use_threshold, int max_iter,
                     float primary, float secondary, float threshold,
                     uint32_t* scratch, long long per_cluster, int cluster,
                     int grid, int8_t* dec, int8_t* conv, int32_t* iters,
                     void* stream) {
  Params p{};
  p.llr = llr;
  p.syn = syn;
  p.table = table;
  p.scratch = scratch;
  p.per_cluster = per_cluster;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
  p.max_deg = max_deg;
  p.cluster = cluster;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = kDecode;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.dec_out = dec;
  p.conv = conv;
  p.iters = iters;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream));
}

int qc_stream_mc(unsigned k0, unsigned k1, int frame0, int num_errors,
                 int batch, const int32_t* table, int mb, int nb, int z,
                 int num_be, int max_deg, int flags, int use_threshold,
                 int max_iter, float log_p, float primary, float secondary,
                 float threshold, uint32_t* scratch, long long per_cluster,
                 int cluster, int grid, int8_t* conv, int8_t* keys,
                 int32_t* iters, void* stream) {
  Params p{};
  p.table = table;
  p.scratch = scratch;
  p.per_cluster = per_cluster;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
  p.max_deg = max_deg;
  p.cluster = cluster;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = kMc;
  p.log_p = log_p;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.conv = conv;
  p.keys = keys;
  p.iters = iters;
  const McDraw d{McKey{k0, k1}, frame0, num_errors,
                 mc_idx_bits((long long)nb * z)};
  if (num_errors < 0 || (long long)num_errors > (long long)nb * z ||
      frame0 < 0)
    return (int)cudaErrorInvalidValue;
  return launch(p, flags, grid, static_cast<cudaStream_t>(stream), d);
}

}  // extern "C"
