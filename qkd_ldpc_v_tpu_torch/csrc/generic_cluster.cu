// Streamed generic LDPC decoder for Hopper (sm_90a), trial mode of the
// min-sum family (NMSA/OMSA/ANMSA/AOMSA), flooding: one thread-block
// cluster decodes a group of F frames at a time of an arbitrary sparse
// parity-check matrix too large for one block's shared memory, such as the
// N=102400 alist code (M=31744, E=307,200), from Alice's and Bob's raw keys
// to the frames' statistics, with every frame's decoder state on chip.
//
// Replaces, in trial mode, the four TPU kernels of qkd_ldpc_v_tpu/ops/
// pallas_stream.py::_build and the XLA while-loop that drives them (kernel_i
// initial staging, kernel_s Alice's syndrome, kernel_a the check pass,
// kernel_b the bit pass and the key compare). The batch-minor kernel of
// csrc/generic_stream.cu still serves decode mode (its f32 LLR plane), the
// SPA pair (no two-minimum form), codes with a check of more than
// kMaxDegree edges, more than kMaxGroups degree groups a side or a frame no
// cluster holds, and launches that pin its group size; ops/generic_stream.py
// ::cluster_plan routes. The plain torch version it is held to, bit for
// bit, is ops/decoders.py::make_decoder in float32 plus calculate_syndrome
// and the key compare, as for both other generic kernels.
//
// Design (ops/generic_stream.py::cluster_plan mirrors the layout).
//   * A cluster of C CTAs (1-16) decodes a group of F frames (1, 2, 4 or
//     8): the largest group up to 8 that one CTA holds, else 8 frames in the
//     smallest cluster whose per-CTA share fits in 227 KB (at the 100k alist
//     code F = 8 in C = 16, 7 clusters in flight; the 10k alist code F = 4
//     in C = 1). CTA r holds internal bits r*S .. r*S + S - 1 (S = N / C
//     rounded up to 32) of every frame of the group: their f32 totals
//     ([S][F], frame-minor) and Alice's and Bob's key bits ([S][F] bits);
//     and checks r*Sc .. r*Sc + Sc - 1 (Sc likewise from M): their syndrome
//     bits ([Sc][F]). Thread tid serves node tid / F of a sweep for frame
//     tid % F, so the F threads of a node read F neighbouring totals or
//     records with one request and one table word (a frame a cluster, each
//     random gather serving one frame, was 1.7 times as slow at the 100k
//     code). A
//     check-pass read of an edge's totals is a shared::cluster load: each
//     check edge's table word is the rank and local index of its bit (rank
//     << 24 | local), turned into an address by mapa.
//   * Min-sum check->bit values are stored compressed per check and frame
//     in the cluster's global slice, one 16-byte record ([M][F]): the
//     clamped value pair (p1, p2) of an edge whose message is positive with
//     |m| != min1 and with |m| == min1, then two words of two bits per edge
//     (m > 0, |m| == min1), so a check of up to 32 edges fits. The value
//     depends on an edge's message only through those two bits, and an
//     edge with m <= 0 takes the exact negation (-p; every sign bit set
//     where the clamp's threshold is negative, which maps every value to
//     the threshold), so the record rebuilds minsum_value's value bit for
//     bit, ties, +-0 and the NaN-keeping min and max included, and the
//     second minimum follows the generic decoder's rule (inf where every |m|
//     of a check of two or more edges is inf). The slices of the clusters in
//     flight (31.3 MB at the 100k code) and the tables shared by all
//     clusters (2.9 MB) stay in the 50 MB L2: HBM carries the keys.
//   * Tables (ops/generic_stream.py::cluster_tables): the check and bit
//     degree groups (node_start, count, degree, edge_offset), kept in
//     shared memory, then the check edges' words and the bit edges' words
//     (check << 5 | slot), both slot-major within their degree groups, so
//     that a warp's neighbouring nodes read neighbouring words, one table
//     read an edge; then each internal bit's external index.
//   * Flooding, as the fused generic kernel: the check pass reads each
//     edge's total and the check's old record, forms each message as
//     clamp(t - v) (the first sweep's channel messages unclamped; every
//     record starts as one whose values rebuild as +0), takes the check's
//     decision parity (the adaptive pair's factor; the convergence test of
//     the sweep before) and writes the new record; the bit pass forms each
//     of the CTA's totals as ((llr + v_0) + v_1) + ... over the bit's edges
//     in slot order, the plain decoder's llr-first association, under
//     -fmad=false, no fast math and no flush-to-zero. A check of at most
//     kRun edges keeps its totals in a register run of 6, 8, ..., 16 slots
//     with every load in flight at once (the run's last slot loads nothing
//     past the check's degree); longer checks take two passes.
//   * Per-thread state: what no thread changes (the shares, the sweep P,
//     the shared offsets, the table sections, the fill and the clamp) is
//     formed once by generic_cluster_trial and read from the parameter
//     bank; slot and lane are shifts of tid; shared memory is addressed by
//     32-bit offsets from the dynamic shared base. A thread keeps its rank,
//     its vote slot and its cluster's records in registers.
//   * Per-frame exit at the iteration the plain decoder gives, on a
//     cluster-wide vote of a mask of frames: the adaptive pair on the
//     decisions before the sweep, the others on those of the sweep before,
//     one parity-only pass after the last sweep. A frame that has left
//     keeps its totals while the group's others iterate on (the group
//     waste: 1.06 at the 100k code's QBER 0.03, F = 8). Two cluster
//     barriers an iteration.
//   * Frame walk: a persistent grid of as many clusters as fit at once
//     (cudaOccupancyMaxActiveClusters); each cluster takes its next group
//     from an atomic counter (zeroed by the launch), so groups that run to
//     the iteration cap leave no tail of idle clusters.
//
// What bounds it on this card: the memory requests in flight, more than one
// thread's chain. One 1024-thread CTA an SM (the shares fill its shared
// memory), 64 registers a thread, 32 warps, each waiting on chains of table
// word -> shared::cluster total (check pass) and table word -> record in L2
// (bit pass); halving the threads costs 40 %. Neither the L2 nor the
// SM-to-SM network is saturated (a cluster's time per iteration is the
// same with 2 or 15 clusters in flight). Yet a thread that takes two checks
// at once, every load of both in flight, was 2.4-5.5 % slower at the 100k
// code in every form tried (with the per-thread state above, with spills
// and without, with the node's table words shared by shuffles), and
// shuffling the table words alone was 1 % slower; what paid was fewer
// requests (no load for a run's last slot past a check's degree) and fewer
// instructions a load (no predicate where a slot always loads). The next
// node's table words fetched ahead and two frames a thread spilled and were
// slower. PERF.md has the measured chunk times beside their bounds.

#include <cfloat>
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
// Degree groups a side may have (their descriptors sit in shared memory).
constexpr int kMaxGroups = 32;
// Edges of a check that its record's two words hold.
constexpr int kMaxDegree = 32;
// A check edge's table word: the bit's rank above kLocalBits, its index in
// that CTA's share below.
constexpr int kLocalBits = 24;
constexpr uint32_t kLocalMask = (1u << kLocalBits) - 1u;
// A bit edge's table word: the check above kSlotBits, its slot below.
constexpr int kSlotBits = 5;
// Checks of at most kRun edges keep their totals in registers.
constexpr int kRun = 16;
// A bit's stored values are loaded kBitRun at a time before any is added.
constexpr int kBitRun = 4;
// Frames a cluster decodes at once, at most.
constexpr int kMaxFrames = 8;

// Clamp bounds: [-threshold, threshold] where the clamp applies, else
// [-inf, inf], which min.NaN / max.NaN pass every value through unchanged.
struct Bounds {
  float lo, hi;
};

// What a launch decodes, and the values every thread reads but no thread
// changes, formed once on the host (generic_cluster_trial) and read from
// the parameter bank where they are used.
struct Params {
  const int8_t* alice;    // [B, N] 0/1, external order
  const int8_t* bob;      // [B, N] 0/1
  const int4* groups;     // check, then bit degree groups (cluster_tables)
  const uint32_t* cedge;  // [E] rank << 24 | local, slot-major
  const uint32_t* bedge;  // [E] check << 5 | slot, slot-major
  const int* bit_ext;     // [N]
  uint4* records;         // [clusters][M][F] compressed checks
  int* next;              // the next frame to take (zeroed by the launch)
  int n, m, check_groups, bit_groups, cluster, batch, max_iter,
      use_threshold;
  int share, check_share;  // S and Sc: one CTA's bits and checks
  int sweep;               // P = T / F: nodes a sweep of the CTA's threads
  uint32_t totals, alice_bits, bob_bits;  // shared offsets (SharedLayout)
  uint32_t cluster_records;               // uint4 of one cluster's records
  float log_p, primary, secondary;
  uint32_t fill;   // every sign bit set where the threshold is negative
  Bounds values;   // the clamp of check->bit values
  int8_t* conv;    // [B]
  int8_t* keys;    // [B]
  int32_t* iters;  // [B]
};

// f32 min and max that return NaN where either operand is NaN, as
// torch.minimum / torch.maximum do.
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

__device__ __forceinline__ float clamp_to(float x, Bounds b) {
  return min_nan(max_nan(x, b.lo), b.hi);
}

// A bit->check message t - v as the pass forms it: clamped where CLAMP
// (the sweeps after the first, where the clamp applies).
template <bool CLAMP>
__device__ __forceinline__ float message(const Params& p, float tv) {
  return CLAMP ? clamp_to(tv, p.values) : tv;
}

// The min-sum check->bit value (unclamped) of an edge with m > 0 (plain:
// ops/decoders.py::_minsum_values with excl = 1).
template <bool OFFSET>
__device__ __forceinline__ float minsum_from(float eabs, float row_sign,
                                             float f) {
  if (OFFSET) return row_sign * 1.f * max_nan(eabs - f, 0.f);
  return f * row_sign * 1.f * eabs;
}

// ---------------------------------------------------------------------------
// Layout (mirrored by ops/generic_stream.py::cluster_plan).
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// One CTA's share of `count` nodes: count / C rounded up to 32.
__host__ __device__ inline int share_of(int count, int cluster) {
  return ((count + cluster - 1) / cluster + 31) / 32 * 32;
}

__host__ __device__ inline int threads_for(int n, int m, int frames,
                                           int cluster) {
  const int s = share_of(n, cluster), sc = share_of(m, cluster);
  const int t = frames * (s > sc ? s : sc);
  return t < kMaxThreads ? t : kMaxThreads;
}

// Byte offsets of one CTA's shared memory: the check and bit degree groups,
// the cluster votes, the next frames and the syndrome bits of its checks
// ([Sc][F] bits) at fixed offsets; then its totals ([S][F] f32), Alice's and
// Bob's bits of its share ([S][F] bits each).
constexpr uint32_t kCheckGroupsAt = 0;
constexpr uint32_t kBitGroupsAt = 16 * kMaxGroups;
constexpr uint32_t kVotesAt = kBitGroupsAt + 16 * kMaxGroups;
constexpr uint32_t kNextAt = kVotesAt + sizeof(int) * 2 * kMaxCluster;
constexpr uint32_t kSynAt = (kNextAt + sizeof(int) + 15) / 16 * 16;

struct SharedLayout {
  size_t totals, alice, bob, bytes;
};

__host__ __device__ inline SharedLayout shared_layout(int n, int m,
                                                      int frames,
                                                      int cluster) {
  SharedLayout s;
  const size_t share = (size_t)share_of(n, cluster) * frames;
  s.totals = align16(kSynAt + (size_t)share_of(m, cluster) * frames / 8);
  s.alice = s.totals + sizeof(float) * share;
  s.bob = s.alice + share / 8;
  s.bytes = s.bob + share / 8;
  return s;
}

// Bytes of one cluster's records ([M][F] of 16 bytes), 256-byte aligned.
__host__ __device__ inline size_t record_bytes(int m, int frames) {
  return ((size_t)16 * m * frames + 255) / 256 * 256;
}

// ---------------------------------------------------------------------------
// One CTA's view of its cluster. Thread tid serves node slot tid / F of a
// sweep (P = T / F nodes a sweep) for frame lane tid % F of the group; the
// rest of what it reads is in Params or at fixed shared offsets.
// ---------------------------------------------------------------------------

struct Cta {
  int rank;       // this CTA's rank in its cluster
  int vote_slot;  // the vote slot the next cluster_or takes
  uint4* rec;     // [M][F] this cluster's records
};

template <int F>
__device__ __forceinline__ int slot_of() {
  return (int)(threadIdx.x / F);
}

template <int F>
__device__ __forceinline__ int lane_of() {
  return (int)(threadIdx.x % F);
}

// This CTA's nodes of `total`: its share, or what is left of them.
__device__ __forceinline__ int nodes_of(int total, int share, int rank) {
  return max(0, min(share, total - rank * share));
}

__device__ __forceinline__ unsigned char* shared_base() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

template <typename T>
__device__ __forceinline__ T* shared_at(uint32_t off) {
  return reinterpret_cast<T*>(shared_base() + off);
}

template <typename T>
__device__ __forceinline__ T* remote(T* local, int rank) {
  return cg::this_cluster().map_shared_rank(local, (unsigned)rank);
}

// The shared::cluster address of byte `off` past byte `at` of CTA `rank`'s
// shared memory.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t at, uint32_t rank,
                                                 uint32_t off) {
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(shared_base()) + at;
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(sa), "r"(rank));
  return a + off;
}

// A 32-bit load from the cluster's shared memory; the second form loads only
// where `on` (else 0). Volatile: it is ordered with the cluster barriers, and
// the compiler forms each address just before its load rather than holding
// the addresses of every load in flight.
__device__ __forceinline__ uint32_t cluster_load(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t cluster_load(uint32_t addr, bool on) {
  uint32_t v = 0u;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
      "@p ld.shared::cluster.u32 %0, [%1];\n\t}"
      : "+r"(v)
      : "r"(addr), "r"((uint32_t)on));
  return v;
}

// The lane's total of the bit a check edge's word names (the second form:
// where `on`, else 0): the F lanes of a node read F neighbouring floats, one
// request.
template <int F>
__device__ __forceinline__ float edge_total(const Params& p, uint32_t w,
                                            bool on) {
  return __uint_as_float(cluster_load(
      cluster_addr(p.totals, w >> kLocalBits,
                   4u * ((w & kLocalMask) * F + (uint32_t)lane_of<F>())),
      on));
}

template <int F>
__device__ __forceinline__ float edge_total(const Params& p, uint32_t w) {
  return __uint_as_float(cluster_load(
      cluster_addr(p.totals, w >> kLocalBits,
                   4u * ((w & kLocalMask) * F + (uint32_t)lane_of<F>()))));
}

// The lane's Alice bit of the bit a check edge's word names: the F lanes of
// a node read one word.
template <int F>
__device__ __forceinline__ int edge_alice(const Params& p, uint32_t w) {
  const uint32_t b = (w & kLocalMask) * F + (uint32_t)lane_of<F>();
  const uint32_t word = cluster_load(
      cluster_addr(p.alice_bits, w >> kLocalBits, 4u * (b >> 5)));
  return (word >> (b & 31)) & 1;
}

__device__ __forceinline__ int packed_bit(const uint32_t* words, int j) {
  return (words[j >> 5] >> (j & 31)) & 1;
}

// The OR of v over every thread of the cluster; a cluster barrier. Two
// slots in turn: a slot is read right after its barrier and written again
// only after the next one.
__device__ unsigned cluster_or(const Params& p, Cta& c, unsigned v) {
  v = __reduce_or_sync(0xffffffffu, v);
  int* slot = shared_at<int>(kVotesAt) + c.vote_slot * kMaxCluster;
  if (threadIdx.x == 0) slot[c.rank] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && v != 0) atomicOr(&slot[c.rank], (int)v);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < p.cluster; ++k)
      if (k != c.rank) remote(slot, k)[c.rank] = slot[c.rank];
  cg::this_cluster().sync();
  unsigned out = 0;
  for (int k = 0; k < p.cluster; ++k) out |= (unsigned)slot[k];
  c.vote_slot ^= 1;
  return out;
}

// Where a node's edges sit in a slot-major table: slot k at b + k * s.
struct Row {
  int b, s, deg;
  __device__ __forceinline__ int at(int k) const { return b + k * s; }
};

// The Row of `node` among degree groups sorted by node_start; g is the
// caller's cursor, which only moves forward (a thread visits its nodes in
// ascending order within a pass).
__device__ __forceinline__ Row row_of(const int4* groups, int count, int node,
                                      int& g) {
  while (g + 1 < count && node >= groups[g + 1].x) ++g;
  const int4 gr = groups[g];
  return Row{gr.w + (node - gr.x), gr.y, gr.z};
}

// ---------------------------------------------------------------------------
// Compressed checks.
// ---------------------------------------------------------------------------

// The check->bit value of slot k of a stored check.
__device__ __forceinline__ float stored_value(uint4 r, int k) {
  const uint32_t b = (k < 16 ? r.z : r.w) >> (2 * (k & 15));
  const float v = __uint_as_float(b & 2u ? r.y : r.x);
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
  __device__ __forceinline__ float second(int deg) const {
    return (deg >= 2 && isinf(min1)) ? min1 : min2;
  }
  __device__ __forceinline__ float row_sign(int sbit) const {
    return (sbit ? -1.f : 1.f) * (neg == 0 ? 1.f : -1.f);
  }
};

// A check's new record from its chain and edge words.
template <bool OFFSET>
__device__ __forceinline__ uint4 new_record(const Params& p, const TwoMin& tm,
                                            int deg, int sbit, float f,
                                            uint32_t w0, uint32_t w1) {
  const float rs = tm.row_sign(sbit);
  return make_uint4(
      __float_as_uint(clamp_to(minsum_from<OFFSET>(tm.min1, rs, f), p.values)),
      __float_as_uint(
          clamp_to(minsum_from<OFFSET>(tm.second(deg), rs, f), p.values)),
      w0 | p.fill, w1 | p.fill);
}

// The two bits of slot k of a new check.
__device__ __forceinline__ uint32_t edge_bits(float mm, float min1, int k) {
  return ((mm > 0.f ? 1u : 0u) | (fabsf(mm) == min1 ? 2u : 0u))
         << (2 * (k & 15));
}

template <int R>
struct Run {
  static constexpr int value = R;
};

template <typename Fn>
__device__ __forceinline__ int with_run(int deg, Fn&& f) {
  if (deg <= 6) return f(Run<6>{});
  if (deg <= 8) return f(Run<8>{});
  if (deg <= 10) return f(Run<10>{});
  if (deg <= 12) return f(Run<12>{});
  if (deg <= 14) return f(Run<14>{});
  return f(Run<kRun>{});
}

// One check of at most R edges for the thread's lane (the CTA's check q,
// its edges at row): loads its table words, its old record, its syndrome bit
// and its totals before it uses any, turns each total into its message
// t - v (slots past deg: +inf, which moves no minimum, sign or parity) and
// writes the check's new record. Returns the decision parity of the totals
// it read. Slots past deg read slot 0's total again, but the last slot,
// past deg, loads nothing: with runs of 6, 8, ..., 16 it is the only slot
// past deg of every check over 5 edges (a third of the 100k code's checks
// have 9 edges in the 10-slot run).
template <int R, bool ADAPTIVE, bool OFFSET, bool CLAMP, int F>
__device__ __forceinline__ int minsum_run(const Params& p, const Cta& c,
                                          int q, Row row) {
  const int deg = row.deg, lane = lane_of<F>();
  uint4* rec = c.rec + (size_t)(c.rank * p.check_share + q) * F + lane;
  uint32_t w[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    w[k] = k + 1 < R || k < deg ? __ldg(p.cedge + row.at(k < deg ? k : 0))
                                : 0u;
  const uint4 old = __ldcg(rec);
  const int sbit = packed_bit(shared_at<uint32_t>(kSynAt), q * F + lane);
  float m[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    m[k] = k + 1 < R ? edge_total<F>(p, w[k])
                     : edge_total<F>(p, w[k], k < deg);
  TwoMin tm;
  int par = sbit;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k < deg && m[k] <= 0.f) par ^= 1;
    m[k] = k < deg ? message<CLAMP>(p, m[k] - stored_value(old, k))
                   : INFINITY;
    tm.add(k, m[k]);
  }
  const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
  uint32_t nw = 0u;
#pragma unroll
  for (int k = 0; k < R; ++k) nw |= edge_bits(m[k], tm.min1, k);
  *rec = new_record<OFFSET>(p, tm, deg, sbit, fac, nw, 0u);
  return par;
}

// One check of kRun + 1 .. kMaxDegree edges: two passes over its edges.
template <bool ADAPTIVE, bool OFFSET, bool CLAMP, int F>
__device__ int long_check(const Params& p, const Cta& c, int q, Row row) {
  const int deg = row.deg, lane = lane_of<F>();
  uint4* rec = c.rec + (size_t)(c.rank * p.check_share + q) * F + lane;
  const uint4 old = __ldcg(rec);
  const int sbit = packed_bit(shared_at<uint32_t>(kSynAt), q * F + lane);
  TwoMin tm;
  int par = sbit;
  for (int k = 0; k < deg; ++k) {
    const float t = edge_total<F>(p, __ldg(p.cedge + row.at(k)));
    if (t <= 0.f) par ^= 1;
    tm.add(k, message<CLAMP>(p, t - stored_value(old, k)));
  }
  const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
  uint32_t nw0 = 0u, nw1 = 0u;
  for (int k = 0; k < deg; ++k) {
    const float t = edge_total<F>(p, __ldg(p.cedge + row.at(k)));
    const uint32_t bits =
        edge_bits(message<CLAMP>(p, t - stored_value(old, k)), tm.min1, k);
    if (k < 16) nw0 |= bits;
    else nw1 |= bits;
  }
  *rec = new_record<OFFSET>(p, tm, deg, sbit, fac, nw0, nw1);
  return par;
}

// The check pass over this CTA's checks for the thread's lane, messages
// clamped where CLAMP. Returns the OR of the decision parities of the
// totals it read.
template <bool ADAPTIVE, bool OFFSET, bool CLAMP, int F>
__device__ int check_pass(const Params& p, const Cta& c) {
  const int checks = nodes_of(p.m, p.check_share, c.rank);
  const int check0 = c.rank * p.check_share;
  const int4* groups = shared_at<int4>(kCheckGroupsAt);
  int bad = 0, g = 0;
  for (int q = slot_of<F>(); q < checks; q += p.sweep) {
    const Row row = row_of(groups, p.check_groups, check0 + q, g);
    if (row.deg > kRun) {
      bad |= long_check<ADAPTIVE, OFFSET, CLAMP, F>(p, c, q, row);
    } else {
      bad |= with_run(row.deg, [&](auto run) {
        constexpr int R = decltype(run)::value;
        return minsum_run<R, ADAPTIVE, OFFSET, CLAMP, F>(p, c, q, row);
      });
    }
  }
  return bad;
}

// The decision parity of check c over the lane's current totals.
template <int F>
__device__ __forceinline__ int check_parity(const Params& p, Row row,
                                            int sbit) {
  int par = sbit;
  for (int k0 = 0; k0 < row.deg; k0 += kBitRun) {  // loads in flight together
    float t[kBitRun];
#pragma unroll
    for (int k = 0; k < kBitRun; ++k)
      if (k0 + k < row.deg)
        t[k] = edge_total<F>(p, __ldg(p.cedge + row.at(k0 + k)));
#pragma unroll
    for (int k = 0; k < kBitRun; ++k)
      if (k0 + k < row.deg && t[k] <= 0.f) par ^= 1;
  }
  return par;
}

// The lane's stored check->bit value of a bit edge's word (check << 5 |
// slot): the F lanes of a node read F neighbouring records, one request.
template <int F>
__device__ __forceinline__ float edge_value(const Cta& c, uint32_t w) {
  return stored_value(
      __ldcg(c.rec + (size_t)(w >> kSlotBits) * F + lane_of<F>()),
      (int)(w & ((1u << kSlotBits) - 1u)));
}

// The lane's total of this CTA's bit l (its edges at row): ((llr + v_0) +
// v_1) + ... over its edges in slot order, kBitRun values loaded before
// any is added.
template <int F>
__device__ __forceinline__ float bit_total(const Params& p, const Cta& c,
                                           int l, Row row) {
  float total =
      packed_bit(shared_at<uint32_t>(p.bob_bits), l * F + lane_of<F>())
          ? -p.log_p
          : p.log_p;
  for (int k0 = 0; k0 < row.deg; k0 += kBitRun) {
    float v[kBitRun];
#pragma unroll
    for (int k = 0; k < kBitRun; ++k)
      if (k0 + k < row.deg)
        v[k] = edge_value<F>(c, __ldg(p.bedge + row.at(k0 + k)));
#pragma unroll
    for (int k = 0; k < kBitRun; ++k)
      if (k0 + k < row.deg) total = total + v[k];
  }
  return total;
}

// The bit pass over this CTA's bits for the lane's frame where it is still
// active, two bits at a time so that both bits' loads are in flight
// together. A frame that has left keeps its totals.
template <int F>
__device__ void bit_pass(const Params& p, const Cta& c, bool act) {
  if (!act) return;
  const int base = c.rank * p.share, P = p.sweep, lane = lane_of<F>();
  const int count = nodes_of(p.n, p.share, c.rank);
  const int4* groups = shared_at<int4>(kBitGroupsAt);
  float* tot = shared_at<float>(p.totals);
  int g = 0, l = slot_of<F>();
  for (; l + P < count; l += 2 * P) {
    const Row r0 = row_of(groups, p.bit_groups, base + l, g);
    const Row r1 = row_of(groups, p.bit_groups, base + l + P, g);
    const float t0 = bit_total<F>(p, c, l, r0);
    const float t1 = bit_total<F>(p, c, l + P, r1);
    tot[l * F + lane] = t0;
    tot[(l + P) * F + lane] = t1;
  }
  if (l < count)
    tot[l * F + lane] =
        bit_total<F>(p, c, l, row_of(groups, p.bit_groups, base + l, g));
}

// ---------------------------------------------------------------------------
// One group of F frames.
// ---------------------------------------------------------------------------

// Frame f0 + k of the group records its statistics (rank 0's first F
// threads, k = tid) where `mask` holds k.
__device__ __forceinline__ void record(const Params& p, const Cta& c, int f0,
                                       unsigned mask, int conv, int iters) {
  const int tid = threadIdx.x;
  if (c.rank == 0 && tid < 32 && ((mask >> tid) & 1)) {
    p.conv[f0 + tid] = (int8_t)conv;
    p.iters[f0 + tid] = iters;
  }
}

template <bool ADAPTIVE, bool OFFSET, int F>
__device__ void decode_group(const Params& p, Cta& c, int f0) {
  const int nf = min(F, p.batch - f0);
  const unsigned all = (1u << nf) - 1u;
  const int tid = threadIdx.x, lane = lane_of<F>();
  const bool live = lane < nf;
  const int bit0 = c.rank * p.share, check0 = c.rank * p.check_share;
  const int count = nodes_of(p.n, p.share, c.rank);
  float* tot = shared_at<float>(p.totals);
  uint32_t* alice = shared_at<uint32_t>(p.alice_bits);
  // This CTA's key bits and the first totals, the channel LLRs: thread tid
  // serves node l0 + tid for every frame of the group (neighbouring threads
  // read neighbouring bytes of a frame's row); the 32 / F nodes of a word
  // gather their F-bit chunks (whole warps: S and T are multiples of 32).
  for (int l0 = 0; l0 < p.share; l0 += blockDim.x) {
    const int l = l0 + tid;
    const bool in = l < count;
    const int j = in ? __ldg(p.bit_ext + bit0 + l) : 0;
    uint32_t a = 0u, b = 0u;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      if (in && k < nf) {
        const size_t at = (size_t)(f0 + k) * p.n + j;
        const bool one = p.bob[at] == 1;
        a |= (uint32_t)(p.alice[at] & 1) << k;
        b |= (uint32_t)one << k;
        tot[l * F + k] = one ? -p.log_p : p.log_p;
      }
    }
    constexpr int kNodes = 32 / F;  // nodes a word holds
    a <<= F * (tid % kNodes);
    b <<= F * (tid % kNodes);
#pragma unroll
    for (int s = 1; s < kNodes; s <<= 1) {
      a |= __shfl_xor_sync(0xffffffffu, a, s);
      b |= __shfl_xor_sync(0xffffffffu, b, s);
    }
    if (tid % kNodes == 0 && l < p.share) {
      alice[l / kNodes] = a;
      shared_at<uint32_t>(p.bob_bits)[l / kNodes] = b;
    }
  }
  cg::this_cluster().sync();  // Alice's bits, read across the cluster
  // The syndrome bits of this CTA's checks, the parity of Alice's bits on
  // each, and every check stored as a message-free one, whose values
  // rebuild as +0 (a -0 pair, negated; +0 where the fill keeps the sign).
  // Thread tid of sweep q0 serves bit q0 * F + tid of the [Sc][F] plane.
  const int checks = nodes_of(p.m, p.check_share, c.rank);
  const int4* cgroups = shared_at<int4>(kCheckGroupsAt);
  uint32_t* syn = shared_at<uint32_t>(kSynAt);
  const float zero = p.fill ? 0.f : -0.f;
  int g = 0;
  for (int q0 = 0; q0 < p.check_share; q0 += p.sweep) {
    const int q = q0 + slot_of<F>();
    int bit = 0;
    if (q < checks) {
      const Row row = row_of(cgroups, p.check_groups, check0 + q, g);
      if (live)
        for (int k = 0; k < row.deg; ++k)
          bit ^= edge_alice<F>(p, __ldg(p.cedge + row.at(k)));
      c.rec[(size_t)(check0 + q) * F + lane] = make_uint4(
          __float_as_uint(zero), __float_as_uint(zero), p.fill, p.fill);
    }
    const uint32_t w = __ballot_sync(0xffffffffu, bit);
    const int b0 = q0 * F + (tid & ~31);
    if ((tid & 31) == 0 && b0 < p.check_share * F) syn[b0 >> 5] = w;
  }
  __syncthreads();

  unsigned active = all;
  for (int it = 0; it < p.max_iter; ++it) {
    // The first sweep reads the channel LLRs unclamped.
    int bad = 0;
    if ((active >> lane) & 1)
      bad = p.use_threshold && it > 0
                ? check_pass<ADAPTIVE, OFFSET, true, F>(p, c)
                : check_pass<ADAPTIVE, OFFSET, false, F>(p, c);
    // The adaptive pair: converged on the decisions before this sweep. The
    // others: on the decisions of the previous sweep (none before the
    // first). Either way the totals read are kept. The vote's barrier also
    // orders the pass's reads of totals and writes of records before the
    // bit pass.
    const unsigned unsat = cluster_or(p, c, bad ? 1u << lane : 0u);
    const unsigned stay = active & ((ADAPTIVE || it > 0) ? unsat : all);
    record(p, c, f0, active & ~stay, 1, ADAPTIVE ? it + 1 : it);
    active = stay;
    if (active == 0) break;
    bit_pass<F>(p, c, (active >> lane) & 1);
    cg::this_cluster().sync();
  }
  if (!ADAPTIVE && active != 0 && p.max_iter > 0) {
    int bad = 0;
    if ((active >> lane) & 1) {
      g = 0;
      for (int q = slot_of<F>(); q < checks; q += p.sweep)
        bad |= check_parity<F>(
            p, row_of(cgroups, p.check_groups, check0 + q, g),
            packed_bit(syn, q * F + lane));
    }
    const unsigned unsat = cluster_or(p, c, bad ? 1u << lane : 0u);
    record(p, c, f0, active & ~unsat, 1, p.max_iter);
    active &= unsat;
  }
  record(p, c, f0, active, 0, p.max_iter);

  // The key compare: every decision of a frame equals Alice's bit.
  int wrong = 0;
  if (live)
    for (int l = slot_of<F>(); l < count; l += p.sweep)
      wrong |= (tot[l * F + lane] <= 0.f ? 1 : 0) !=
               packed_bit(alice, l * F + lane);
  const unsigned bad = cluster_or(p, c, wrong ? 1u << lane : 0u);
  if (c.rank == 0 && tid < nf)
    p.keys[f0 + tid] = (int8_t)(((bad >> tid) & 1) == 0);
}

template <bool ADAPTIVE, bool OFFSET, int F>
__global__ void __launch_bounds__(kMaxThreads, 1)
    generic_stream_kernel_cluster(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  int4* groups = shared_at<int4>(kCheckGroupsAt);
  for (int i = threadIdx.x; i < p.check_groups + p.bit_groups;
       i += blockDim.x)
    groups[i < p.check_groups ? i : kMaxGroups + i - p.check_groups] =
        p.groups[i];
  Cta c;
  c.rank = (int)cluster.block_rank();
  c.vote_slot = 0;
  c.rec = p.records + (size_t)(blockIdx.x / p.cluster) * p.cluster_records;
  int* next = shared_at<int>(kNextAt);
  __syncthreads();

  for (;;) {
    if (c.rank == 0 && threadIdx.x == 0) {
      const int f0 = atomicAdd(p.next, F);
      for (int k = 0; k < p.cluster; ++k) *remote(next, k) = f0;
    }
    cluster.sync();  // also: the last group's shares are no longer read
    const int f0 = *next;
    if (f0 >= p.batch) break;
    decode_group<ADAPTIVE, OFFSET, F>(p, c, f0);
  }
}

typedef void (*KernelFn)(Params);

template <int F>
KernelFn pick(int flags) {
  switch (flags) {
    case 0: return generic_stream_kernel_cluster<false, false, F>;
    case 1: return generic_stream_kernel_cluster<true, false, F>;
    case 2: return generic_stream_kernel_cluster<false, true, F>;
    case 3: return generic_stream_kernel_cluster<true, true, F>;
    default: return nullptr;
  }
}

// flags: bit 0 adaptive, bit 1 offset (OMSA/AOMSA); the min-sum family
// only (ops/fused_generic.py::_flags). frames: the group a cluster decodes
// at once. nullptr for other flags and group sizes.
KernelFn kernel_for(int flags, int frames) {
  switch (frames) {
    case 1: return pick<1>(flags);
    case 2: return pick<2>(flags);
    case 4: return pick<4>(flags);
    case 8: return pick<8>(flags);
    default: return nullptr;
  }
}

bool shape_ok(int n, int m, int e, int check_groups, int bit_groups,
              int frames, int cluster) {
  return n >= 1 && m >= 1 && e >= 1 && check_groups >= 1 &&
         check_groups <= kMaxGroups && bit_groups >= 1 &&
         bit_groups <= kMaxGroups && cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && frames >= 1 &&
         frames <= kMaxFrames && (frames & (frames - 1)) == 0 &&
         share_of(n, cluster) <= (int)kLocalMask &&
         m < (1 << (32 - kSlotBits));
}

// The launch configuration of one kernel (clusters of `cluster` CTAs, the
// whole shared layout), with the kernel's attributes set for it.
int configure(KernelFn kernel, int n, int m, int frames, int cluster,
              int grid, cudaStream_t stream, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr) {
  const size_t smem = shared_layout(n, m, frames, cluster).bytes;
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
  cfg.blockDim = dim3(threads_for(n, m, frames, cluster), 1, 1);
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

}  // namespace

extern "C" {

// Limits and layout the wrapper's plan mirrors (ops/generic_stream.py::
// cluster_plan): degree groups a side, edges a check, frames a group, one
// CTA's threads and shared bytes, one cluster's record bytes.
int generic_cluster_max_groups() { return kMaxGroups; }
int generic_cluster_max_degree() { return kMaxDegree; }
int generic_cluster_max_frames() { return kMaxFrames; }
int generic_cluster_threads(int n, int m, int frames, int cluster) {
  return threads_for(n, m, frames, cluster);
}
long long generic_cluster_shared_bytes(int n, int m, int frames,
                                       int cluster) {
  return (long long)shared_layout(n, m, frames, cluster).bytes;
}
long long generic_cluster_record_bytes(int m, int frames) {
  return (long long)record_bytes(m, frames);
}

// Clusters of `cluster` CTAs, each decoding `frames` frames at once, that
// fit on the current device at once, or a negative CUDA error.
int generic_cluster_resident(int n, int m, int flags, int frames,
                             int cluster) {
  if (!shape_ok(n, m, 1, 1, 1, frames, cluster))
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  KernelFn kernel = kernel_for(flags, frames);
  int err =
      configure(kernel, n, m, frames, cluster, cluster, nullptr, cfg, attr);
  if (err != 0) return -err;
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != 0) return -err;
  return clusters;
}

// A trial launch over `clusters` clusters of `cluster` CTAs, each decoding
// groups of `frames` frames. scratch: 256 bytes for the frame counter, then
// each cluster's records (generic_cluster_record_bytes). Everything the
// threads read but do not change is formed here, once.
int generic_cluster_trial(const int8_t* alice, const int8_t* bob, int batch,
                          const int32_t* table, int n, int m, int e,
                          int check_groups, int bit_groups, int flags,
                          int use_threshold, int max_iter, float log_p,
                          float primary, float secondary, float threshold,
                          void* scratch, int frames, int cluster,
                          int clusters, int8_t* conv, int8_t* keys,
                          int32_t* iters, void* stream) {
  if (!shape_ok(n, m, e, check_groups, bit_groups, frames, cluster) ||
      batch < 1 || clusters < 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const SharedLayout lay = shared_layout(n, m, frames, cluster);
  Params p{};
  p.alice = alice;
  p.bob = bob;
  p.groups = reinterpret_cast<const int4*>(table);
  p.cedge = reinterpret_cast<const uint32_t*>(
      table + 4 * (check_groups + bit_groups));
  p.bedge = p.cedge + e;
  p.bit_ext = reinterpret_cast<const int*>(p.bedge + e);
  p.next = static_cast<int*>(scratch);
  p.records = reinterpret_cast<uint4*>(static_cast<char*>(scratch) + 256);
  p.n = n;
  p.m = m;
  p.check_groups = check_groups;
  p.bit_groups = bit_groups;
  p.cluster = cluster;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.share = share_of(n, cluster);
  p.check_share = share_of(m, cluster);
  p.sweep = threads_for(n, m, frames, cluster) / frames;
  p.totals = (uint32_t)lay.totals;
  p.alice_bits = (uint32_t)lay.alice;
  p.bob_bits = (uint32_t)lay.bob;
  p.cluster_records = (uint32_t)(record_bytes(m, frames) / sizeof(uint4));
  p.log_p = log_p;
  p.primary = primary;
  p.secondary = secondary;
  p.fill = use_threshold && threshold < 0.f ? 0x55555555u : 0u;
  p.values = use_threshold ? Bounds{-threshold, threshold}
                           : Bounds{-INFINITY, INFINITY};
  p.conv = conv;
  p.keys = keys;
  p.iters = iters;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  KernelFn kernel = kernel_for(flags, frames);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure(kernel, n, m, frames, cluster, clusters * cluster, s,
                      cfg, attr);
  if (err != 0) return err;
  err = (int)cudaMemsetAsync(p.next, 0, sizeof(int), s);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
