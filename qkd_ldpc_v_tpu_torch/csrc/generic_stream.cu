// Streamed generic LDPC decoder for Hopper (sm_90a): decodes codes whose
// per-frame state does not fit in one block's shared memory, such as the
// N=102400 alist code (M=31744, E=307,200), a group of F frames per block
// in a batch-minor message layout.
//
// Replaces the four TPU kernels of qkd_ldpc_v_tpu/ops/pallas_stream.py::
// _build and the XLA while-loop that drives them (`step`, :813):
//   kernel_i :524  initial staging    -> the group's bit and check staging
//   kernel_s :589  Alice's syndrome   -> alice_syndrome (generic_decode.cuh)
//   kernel_a :303  check pass, with the decision-syndrome mismatch (early
//                  exit, adaptive factor) -> check_group, settle
//   kernel_b :434  bit pass: totals, decisions, the key compare or the
//                  decision planes    -> bit_nodes and the group's end
// in trial and decode modes, for the min-sum family NMSA/OMSA/ANMSA/AOMSA
// and the SPA pair SPA / SPA-lin-approx (the check update of spa.cuh) on the
// flooding schedule. Trial mode of the min-sum family goes to the cluster
// kernel (csrc/generic_cluster.cu) wherever its plan holds the code
// (ops/generic_stream.py::cluster_plan); this kernel serves decode mode,
// the SPA pair, the codes that plan refuses and launches that pin its
// group size. The while-loop becomes the block's iteration
// loop, which exits per frame. The plain torch version it is held to, bit
// for bit, is ops/decoders.py::make_decoder in float32 (wrapped by
// ops/generic_stream.py), as for the fused generic kernel; its per-edge
// steps are generic_decode.cuh's. None of the TPU machinery crosses
// over: no staged exchange, no stream_plan.py Clos permutes, no bf16x2
// transport, no decision bit in the mantissa. Edges are addressed directly
// through fused_generic.launch_tables (cbit and bedge are 1.2 MB each at
// N=102400 and stay in the 50 MB L2).
//
// Design. A persistent grid of one 1024-thread block per SM; block b decodes
// frame groups b, b + grid, ..., group g holding frames g*F .. g*F+F-1.
// F is 8 or 16 (a template parameter); ops/generic_stream.py takes 16 where
// a launch's groups still fill the grid and 8 below that.
//   * Messages batch-minor: the block's slice of a global scratch holds the
//     group's messages as [E, F] f32 in check-major edge order,
//     msg[k*F + f]. A thread owns one (node, frame) pair, the F lanes of a
//     node being consecutive frames, so every check-pass read and write and
//     every bit-pass gather and scatter of an edge moves F consecutive
//     floats (32 bytes at F=8, 64 at F=16) and each table entry is read
//     once per group, not once per frame. A check's run of messages, and
//     two bits' edges in the bit pass, are loaded before they are summed,
//     so that their loads are in flight together.
//   * Node planes bit-packed across the group (bit f = frame f): decisions
//     (one Mask per bit) in shared memory; Alice's syndrome (one Mask per
//     check) in shared memory at F=8 (N + M = 134,144 bytes at N=102400)
//     and in the slice at F=16, where the decisions alone take 204,800
//     bytes. A check's parity for every frame of the group is one XOR of
//     masks. A bit's decision mask is a warp ballot of its F lanes, written
//     by its lane 0.
//   * The channel LLR is staged once per group in the slice: Bob's bits as
//     one Mask per bit in trial mode (+-log_p is formed at each read by
//     llr_of_bit, the same expression as input_llr), the caller's LLRs as
//     [N, F] f32 in decode mode.
//   * Per-frame exit inside the group: a frame records conv and iters when
//     its decisions satisfy the syndrome (the adaptive pair tests before
//     the check pass, the others after the bit pass, as the plain decoder's
//     `note`), its decisions freeze and its lanes make no more loads or
//     stores; the group iterates until all its frames have converged or the
//     cap. Lanes past the batch in a ragged last group are masked from the
//     start.
//   * One f32 association with the plain decoder: totals llr-first, then
//     the messages in bedge order one by one; min-sum by two_min,
//     row_sign_of, minsum_value and clamp_msg, with their NONFINITE flag as
//     in the fused kernel: min and max keep NaN, and where every |message|
//     of a check is inf its second minimum is inf (last_min2), so that
//     rate-adapted frames whose sums overflow follow the plain decoder too.
//
// What bounds it: the message traffic to HBM. Each group iteration moves
// the [E, F] array four times (check-pass read and write, bit-pass gather
// and scatter), 16 bytes per frame and edge against the 13 operations
// min-sum needs, and the grid's arrays (1.3 GB at F=8, 2.6 GB at F=16)
// cannot stay in the 50 MB L2. The check pass streams its runs; the bit
// pass's gathers and scatters land on runs of F floats scattered over the
// slice, which HBM serves at a fraction of its streaming rate, so the wider
// group pays where the batch fills the grid. A group also iterates to its
// slowest frame. The staging is a small share (PERF.md, "Where the time
// goes", has the measured split); a group spread over several SMs, so that
// its messages stay in L2, is the next design step. The SPA pair moves the
// same messages and adds a tanhf, an atanhf and an IEEE division per edge
// and iteration on the SFU (MUFU), at a quarter of the f32 rate.

#include "generic_decode.cuh"

namespace {

constexpr unsigned kAllLanes = 0xffffffffu;
// A check's messages and a bit's edges are held in registers up to these
// degrees, so that their loads issue together; longer runs read twice.
constexpr int kCheckRun = 16;
constexpr int kBitRun = 8;
// Bits per thread in a bit-pass sweep, so that more gathers are in flight.
constexpr int kBitNodes = 2;

// Frames per group, the type of a node's mask of frames, and where the
// syndrome plane lives: beside the decisions in shared memory at F=8, in
// the block's slice at F=16, where the decisions alone take 2N bytes.
template <int F>
struct Group;
template <>
struct Group<8> {
  typedef uint8_t Mask;
  static constexpr bool kSynShared = true;
};
template <>
struct Group<16> {
  typedef uint16_t Mask;
  static constexpr bool kSynShared = false;
};

__host__ __device__ inline size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Dynamic shared memory of one block: the decision plane, then the syndrome
// plane where it is shared.
template <int F>
__host__ __device__ inline size_t group_shared_bytes(int n, int m) {
  typedef typename Group<F>::Mask Mask;
  const size_t nodes = (size_t)n + (Group<F>::kSynShared ? (size_t)m : 0);
  return round_up(sizeof(Mask) * nodes, 16);
}

// A block's slice of the scratch, in bytes: the messages at 0, then at
// 256-byte boundaries the staged channel plane (`chan`), Alice's bit plane
// in trial mode (`alice`) and the syndrome plane where it is not shared
// (`syn`); `total` is the slice's size.
struct Slice {
  size_t chan, alice, syn, total;
};

template <int F>
__host__ __device__ inline Slice slice_of(int n, int m, int e, bool trial) {
  typedef typename Group<F>::Mask Mask;
  const size_t bits = sizeof(Mask) * (size_t)n;
  Slice s;
  s.chan = round_up(sizeof(float) * (size_t)e * F, 256);
  s.alice = round_up(s.chan + (trial ? bits : sizeof(float) * (size_t)n * F),
                     256);
  s.syn = round_up(s.alice + (trial ? bits : 0), 256);
  s.total = round_up(
      s.syn + (Group<F>::kSynShared ? 0 : sizeof(Mask) * (size_t)m), 256);
  return s;
}

// The F-bit mask of this thread's node from a warp ballot: bit f is the
// vote of the node's lane f.
template <int F>
__device__ __forceinline__ unsigned node_bits(unsigned ballot) {
  const int first = (threadIdx.x & 31) & ~(F - 1);
  return (ballot >> first) & ((1u << F) - 1);
}

// Block-wide OR of v; every thread calls it. Three slots in rotation: the
// slot a call reads is zeroed after the next call's barrier, two calls
// before it is used again.
__device__ __forceinline__ unsigned block_or(unsigned v, unsigned* slots,
                                             int& turn) {
  v = __reduce_or_sync(kAllLanes, v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicOr(&slots[turn], v);
  __syncthreads();
  const unsigned all = slots[turn];
  if (threadIdx.x == 0) slots[(turn + 2) % 3] = 0;
  turn = (turn + 1) % 3;
  return all;
}

// Check pass over check c for the lane's frame: its bit->check messages
// become clamped check->bit messages; the adaptive pair takes the secondary
// factor where the decisions leave the check unsatisfied for this frame.
template <bool ADAPTIVE, bool OFFSET, int F, typename Mask>
__device__ __forceinline__ void check_group(int c, int lane, const Params& p,
                                            const Tables& t, const Mask* dec,
                                            const Mask* syn, float* msg) {
  const int b = t.cptr[c], deg = t.cptr[c + 1] - b;
  float* run = msg + (size_t)b * F + lane;
  const bool s = (syn[c] >> lane) & 1;
  const float f =
      (ADAPTIVE && ((mismatch(c, t.cptr, t.cbit, dec, syn) >> lane) & 1))
          ? p.secondary
          : p.primary;
  float min1 = 0.f, min2 = FLT_MAX;
  int neg = 0;
  if (deg <= kCheckRun) {
    float v[kCheckRun];
#pragma unroll
    for (int j = 0; j < kCheckRun; ++j)
      if (j < deg) v[j] = run[(size_t)j * F];
#pragma unroll
    for (int j = 0; j < kCheckRun; ++j) {
      if (j < deg) {
        two_min<true>(fabsf(v[j]), j == 0, min1, min2);
        neg += v[j] < 0.f;
      }
    }
    min2 = last_min2<true>(deg, min1, min2);
    const float rs = row_sign_of(s, neg);
#pragma unroll
    for (int j = 0; j < kCheckRun; ++j)
      if (j < deg)
        run[(size_t)j * F] = clamp_msg<true>(
            minsum_value<OFFSET, true>(v[j], min1, min2, rs, f), p);
    return;
  }
  for (int j = 0; j < deg; ++j) {
    const float mm = run[(size_t)j * F];
    two_min<true>(fabsf(mm), j == 0, min1, min2);
    neg += mm < 0.f;
  }
  min2 = last_min2<true>(deg, min1, min2);
  const float rs = row_sign_of(s, neg);
  for (int j = 0; j < deg; ++j)
    run[(size_t)j * F] = clamp_msg<true>(
        minsum_value<OFFSET, true>(run[(size_t)j * F], min1, min2, rs, f), p);
}

// Check pass over check c for the lane's frame with the SPA pair: each
// bit->check message becomes its term, then its clamped check->bit value.
// Up to kCheckRun edges the terms stay in registers; longer checks park
// them in the message slots.
template <int CHECK, int F, typename Mask>
__device__ __forceinline__ void check_group_spa(int c, int lane,
                                                const Params& p,
                                                const Tables& t,
                                                const Mask* syn, float* msg) {
  const int b = t.cptr[c], deg = t.cptr[c + 1] - b;
  float* run = msg + (size_t)b * F + lane;
  const bool s = (syn[c] >> lane) & 1;
  if (deg <= kCheckRun) {
    float v[kCheckRun];
#pragma unroll
    for (int j = 0; j < kCheckRun; ++j)
      if (j < deg) v[j] = run[(size_t)j * F];
    float prod = s ? -1.f : 1.f;
#pragma unroll
    for (int j = 0; j < kCheckRun; ++j) {
      if (j < deg) {
        v[j] = spa_term<CHECK>(v[j]);
        prod = prod * v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kCheckRun; ++j)
      if (j < deg)
        run[(size_t)j * F] =
            clamp_msg<true>(spa_extrinsic<CHECK>(prod / v[j]), p);
    return;
  }
  spa_row<CHECK>(
      deg, s,
      [&](int j) {
        return run[(size_t)j * F] = spa_term<CHECK>(run[(size_t)j * F]);
      },
      [&](int j) { return run[(size_t)j * F]; },
      [&](int j, float v) { run[(size_t)j * F] = clamp_msg<true>(v, p); });
}

// Bit pass over R bits is[r] (those with on[r]) for the lane's frame, from
// their channel LLRs tot[r]: the llr-first sequential totals (left in tot)
// and the new bit->check messages. Where every bit's degree is at most
// kBitRun / R, the R bits' table loads, then their message gathers, issue
// together.
template <int F, int R>
__device__ __forceinline__ void bit_nodes(const int* is, const bool* on,
                                          int lane, const Params& p,
                                          const Tables& t, float* tot,
                                          float* msg) {
  constexpr int D = kBitRun / R;
  int b[R], deg[R];
  bool fast = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    b[r] = on[r] ? t.bptr[is[r]] : 0;
    deg[r] = on[r] ? t.bptr[is[r] + 1] - b[r] : 0;
    fast = fast && deg[r] <= D;
  }
  if (fast) {
    int idx[R][D];
    float v[R][D];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < deg[r]) idx[r][j] = t.bedge[b[r] + j] * F + lane;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < deg[r]) v[r][j] = msg[idx[r][j]];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < deg[r]) tot[r] = tot[r] + v[r][j];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < deg[r]) msg[idx[r][j]] = clamp_msg<true>(tot[r] - v[r][j], p);
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k0 = b[r], k1 = b[r] + deg[r];
    for (int k = k0; k < k1; ++k)
      tot[r] = tot[r] + msg[(size_t)t.bedge[k] * F + lane];
    for (int k = k0; k < k1; ++k) {
      const size_t idx = (size_t)t.bedge[k] * F + lane;
      msg[idx] = clamp_msg<true>(tot[r] - msg[idx], p);
    }
  }
}

// The convergence test of a group: every check's parity for all frames at
// once. Frames of `active` whose decisions satisfy the syndrome record conv
// and iters (it + 1); returns the frames that stay active.
template <int F, typename Mask>
__device__ __forceinline__ unsigned settle(const Params& p, const Tables& t,
                                           const Mask* dec, const Mask* syn,
                                           unsigned active, int first, int it,
                                           unsigned* slots, int& turn) {
  unsigned bad = 0;
  for (int c = threadIdx.x; c < p.m; c += blockDim.x)
    bad |= (unsigned)mismatch(c, t.cptr, t.cbit, dec, syn);
  const unsigned unsat = block_or(bad, slots, turn);
  const unsigned newly = active & ~unsat;
  if (threadIdx.x < F && ((newly >> threadIdx.x) & 1)) {
    p.conv[first + threadIdx.x] = 1;
    p.iters[first + threadIdx.x] = it + 1;
  }
  return active & unsat;
}

// CHECK: the check update (spa.cuh), a template flag so that the min-sum
// instantiations keep their code.
template <bool ADAPTIVE, bool OFFSET, int F, int CHECK>
__global__ void __launch_bounds__(kMaxThreads) generic_stream_kernel(Params p) {
  typedef typename Group<F>::Mask Mask;
  extern __shared__ float4 smem[];
  __shared__ unsigned slots[3];
  const int N = p.n, M = p.m;
  const int tid = threadIdx.x;
  const int lane = tid & (F - 1);  // the thread's frame in the group
  const int slot = tid / F;        // the thread's node in a sweep
  const int per = blockDim.x / F;  // nodes per sweep
  const Tables t = tables_of(p);
  const Slice s = slice_of<F>(N, M, p.e, p.mode != kDecode);
  char* mine = reinterpret_cast<char*>(p.scratch) + (size_t)blockIdx.x * s.total;
  float* msg = reinterpret_cast<float*>(mine);
  Mask* bob = reinterpret_cast<Mask*>(mine + s.chan);    // trial
  float* llr = reinterpret_cast<float*>(mine + s.chan);  // decode
  Mask* alice = reinterpret_cast<Mask*>(mine + s.alice);  // trial
  Mask* dec = reinterpret_cast<Mask*>(smem);
  Mask* syn = Group<F>::kSynShared ? dec + N
                                   : reinterpret_cast<Mask*>(mine + s.syn);
  // The channel LLR of internal bit i for the lane's frame, from the plane.
  auto chan = [&](int i) -> float {
    return p.mode != kDecode ? llr_of_bit(p, (bob[i] >> lane) & 1)
                             : llr[(size_t)i * F + lane];
  };
  if (tid < 3) slots[tid] = 0;
  __syncthreads();
  int turn = 0;

  const int groups = (p.batch + F - 1) / F;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int first = g * F;
    const int nf = min(F, p.batch - first);
    const bool live = lane < nf;
    const size_t row = (size_t)(first + lane) * N;

    // Bits: the channel plane, Alice's plane and the first decisions.
    for (int i0 = 0; i0 < N; i0 += per) {
      const int i = i0 + slot;
      const bool on = live && i < N;
      float v = 0.f;
      bool one = false, a = false;
      if (on) {
        v = input_llr(p, t, row, i);
        if (p.mode != kDecode) {
          one = p.bob[row + t.bit_ext[i]] == 1;
          a = p.alice[row + t.bit_ext[i]] & 1;
        }
      }
      if (p.mode != kDecode) {
        const unsigned ones = node_bits<F>(__ballot_sync(kAllLanes, one));
        const unsigned as = node_bits<F>(__ballot_sync(kAllLanes, a));
        if (lane == 0 && i < N) {
          bob[i] = (Mask)ones;
          alice[i] = (Mask)as;
        }
      } else if (on) {
        llr[(size_t)i * F + lane] = v;
      }
      const unsigned d = node_bits<F>(__ballot_sync(kAllLanes, on && v <= 0.f));
      if (lane == 0 && i < N) dec[i] = (Mask)d;
    }
    __syncthreads();
    // Checks: each edge's first message is its bit's LLR; Alice's syndrome,
    // in trial mode the parity of her plane for all frames at once.
    for (int c0 = 0; c0 < M; c0 += per) {
      const int c = c0 + slot;
      unsigned parity = 0;
      int bit = 0;
      if (c < M) {
        for (int k = t.cptr[c]; k < t.cptr[c + 1]; ++k) {
          const int i = t.cbit[k];
          if (live) msg[(size_t)k * F + lane] = chan(i);
          if (p.mode != kDecode) parity ^= alice[i];
        }
        if (live && p.mode == kDecode)
          bit = alice_syndrome(c, p, t, first + lane, 0);
      }
      const unsigned sb =
          p.mode != kDecode
              ? parity
              : node_bits<F>(__ballot_sync(kAllLanes, bit != 0));
      if (lane == 0 && c < M) syn[c] = (Mask)sb;
    }
    __syncthreads();

    unsigned active = (1u << nf) - 1;
    for (int it = 0; it < p.max_iter; ++it) {
      if (ADAPTIVE) {
        active = settle<F>(p, t, dec, syn, active, first, it, slots, turn);
        if (active == 0) break;
      }
      for (int c0 = 0; c0 < M; c0 += per) {
        const int c = c0 + slot;
        if (c < M && ((active >> lane) & 1)) {
          if constexpr (CHECK != kMinSum) {
            check_group_spa<CHECK, F>(c, lane, p, t, syn, msg);
          } else {
            check_group<ADAPTIVE, OFFSET, F>(c, lane, p, t, dec, syn, msg);
          }
        }
      }
      __syncthreads();
      const bool act = (active >> lane) & 1;
      for (int i0 = 0; i0 < N; i0 += kBitNodes * per) {
        int is[kBitNodes];
        bool on[kBitNodes];
        float tot[kBitNodes];
#pragma unroll
        for (int r = 0; r < kBitNodes; ++r) {
          is[r] = i0 + r * per + slot;
          on[r] = act && is[r] < N;
          tot[r] = on[r] ? chan(is[r]) : 0.f;
        }
        bit_nodes<F, kBitNodes>(is, on, lane, p, t, tot, msg);
#pragma unroll
        for (int r = 0; r < kBitNodes; ++r) {
          const unsigned d =
              node_bits<F>(__ballot_sync(kAllLanes, on[r] && tot[r] <= 0.f));
          // Frames that have left keep their frozen decisions.
          if (lane == 0 && is[r] < N)
            dec[is[r]] =
                (Mask)(((unsigned)dec[is[r]] & ~active) | (d & active));
        }
      }
      __syncthreads();
      if (!ADAPTIVE) {
        active = settle<F>(p, t, dec, syn, active, first, it, slots, turn);
        if (active == 0) break;
      }
    }
    if (tid < nf && ((active >> tid) & 1)) {
      p.conv[first + tid] = 0;
      p.iters[first + tid] = p.max_iter;
    }

    // The key compare (trial: the frames where a decision differs from
    // Alice's bit) or the decision planes (decode).
    if (p.mode != kDecode) {
      unsigned wrong = 0;
      for (int i = tid; i < N; i += blockDim.x) wrong |= dec[i] ^ alice[i];
      const unsigned bad = block_or(wrong, slots, turn);
      if (tid < nf) p.keys[first + tid] = (int8_t)(((bad >> tid) & 1) == 0);
    } else {
      for (int i0 = 0; i0 < N; i0 += per) {
        const int i = i0 + slot;
        if (live && i < N)
          p.dec_out[row + t.bit_ext[i]] = (int8_t)((dec[i] >> lane) & 1);
      }
    }
    __syncthreads();  // the next group overwrites the planes
  }
}

typedef void (*KernelFn)(Params);

// flags: bit 0 adaptive, bit 1 offset (OMSA/AOMSA), bits 2-3 the check
// update (4 SPA, 8 SPA-lin; neither adaptive nor offset). nullptr for flags
// without a kernel.
template <int F>
KernelFn pick(int flags) {
  const int check = (flags >> 2) & 3;
  if (check != kMinSum) {
    if ((flags & 3) != 0) return nullptr;
    if (check == kSpa) return generic_stream_kernel<false, false, F, kSpa>;
    if (check == kSpaLin) return generic_stream_kernel<false, false, F, kSpaLin>;
    return nullptr;
  }
  switch (flags & 3) {
    case 0: return generic_stream_kernel<false, false, F, kMinSum>;
    case 1: return generic_stream_kernel<true, false, F, kMinSum>;
    case 2: return generic_stream_kernel<false, true, F, kMinSum>;
    default: return generic_stream_kernel<true, true, F, kMinSum>;
  }
}

// The kernel of a group size (8 or 16 frames) and flags, or nullptr.
KernelFn kernel_for(int flags, int group) {
  if (group == 8) return pick<8>(flags);
  if (group == 16) return pick<16>(flags);
  return nullptr;
}

long long shared_of(int n, int m, int group) {
  if (group == 8) return (long long)group_shared_bytes<8>(n, m);
  if (group == 16) return (long long)group_shared_bytes<16>(n, m);
  return -1;
}

long long scratch_of(int n, int m, int e, int group, int trial) {
  const bool tr = trial != 0;
  if (group == 8) return (long long)slice_of<8>(n, m, e, tr).total;
  if (group == 16) return (long long)slice_of<16>(n, m, e, tr).total;
  return -1;
}

int prepare(KernelFn kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch(const Params& p, int flags, int group, int grid, int threads,
           cudaStream_t stream) {
  KernelFn kernel = kernel_for(flags, group);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || grid < 1 || p.batch < 1 || p.scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)shared_of(p.n, p.m, group);
  int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (the decision plane, and
// the syndrome plane at F=8), or -1 for a group size without a kernel.
long long generic_stream_shared_bytes(int n, int m, int group) {
  return shared_of(n, m, group);
}

// Bytes of one block's slice of the scratch (messages, channel plane,
// Alice's plane in trial mode, the syndrome plane at F=16), or -1 for a
// group size without a kernel.
long long generic_stream_scratch_bytes(int n, int m, int e, int group,
                                       int trial) {
  return scratch_of(n, m, e, group, trial);
}

// Blocks of this configuration that fit on the current device at once
// (occupancy per SM times the SM count), or a negative CUDA error.
int generic_stream_resident_blocks(int n, int m, int flags, int group,
                                   int threads) {
  KernelFn kernel = kernel_for(flags, group);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  const size_t smem = (size_t)shared_of(n, m, group);
  int err = prepare(kernel, smem);
  if (err != 0) return -err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != 0) return -err;
  int device = 0, sms = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return -err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (err != 0) return -err;
  return per_sm * sms;
}

int generic_stream_trial(const int8_t* alice, const int8_t* bob, int batch,
                         const int32_t* table, int n, int m, int e, int flags,
                         int use_threshold, int max_iter, float log_p,
                         float primary, float secondary, float threshold,
                         int group, void* scratch, int grid, int threads,
                         int8_t* conv, int8_t* keys, int32_t* iters,
                         void* stream) {
  Params p{};
  p.alice = alice;
  p.bob = bob;
  p.table = table;
  p.scratch = static_cast<float*>(scratch);
  p.n = n;
  p.m = m;
  p.e = e;
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
  return launch(p, flags, group, grid, threads,
                static_cast<cudaStream_t>(stream));
}

int generic_stream_decode(const float* llr, const int8_t* syn, int batch,
                          const int32_t* table, int n, int m, int e, int flags,
                          int use_threshold, int max_iter, float primary,
                          float secondary, float threshold, int group,
                          void* scratch, int grid, int threads, int8_t* dec,
                          int8_t* conv, int32_t* iters, void* stream) {
  Params p{};
  p.llr_in = llr;
  p.syn_in = syn;
  p.table = table;
  p.scratch = static_cast<float*>(scratch);
  p.n = n;
  p.m = m;
  p.e = e;
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
  return launch(p, flags, group, grid, threads,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
