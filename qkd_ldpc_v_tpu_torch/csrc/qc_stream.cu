// Streamed QC-LDPC decoder for Hopper (sm_90a): one thread block decodes one
// frame at a time, with the frame's bit totals and check->bit extrinsics in a
// global scratch of its own, from raw keys (trial mode), from LLRs and a
// syndrome (decode mode) or from keys it draws itself (mc mode) to its
// per-frame statistics or decisions.
//
// Replaces the TPU kernel
// qkd_ldpc_v_tpu/ops/pallas_qc_stream.py::_build.kernel (trial, decode and
// mc modes; the min-sum family NMSA/OMSA/ANMSA/AOMSA on the flooding and
// layered schedules; the SPA pair SPA / SPA-lin-approx on the flooding
// schedule, with the check update of csrc/spa.cuh). The mc mode draws
// Alice's keys and the error sort keys from the chunk's Philox stream
// (philox.cuh), keeps the sort keys in the slice's extrinsic region for the
// exact selection and Alice's and Bob's keys as byte planes in the slice
// (where the TPU kernel spills Alice's keys to HBM), and then decodes as
// trial mode does; the plain version of its
// keys is ops/channel.py::mc_channel. It serves the QC codes whose per-frame
// state does not fit in one block's shared memory (csrc/fused_qc.cu's
// limit), e.g. every N=102400 asset. The plain torch versions it is held to,
// bit for bit, are in qkd_ldpc_v_tpu_torch/ops/qc_decoder.py; they equal the
// fused QC kernel, so the two kernels give the same results wherever both
// run.
//
// Circulant convention: check-aligned index z of block edge (r, c, s) is
// bit (c, (z + s) mod Z).
//
// Design.
//   * Launch shape: a persistent grid of as many blocks as fit on the card
//     at once (occupancy per SM times the SM count); block b decodes frames
//     b, b + grid, ... Each block owns a slice of a global scratch that the
//     caller allocates: the bit totals (N f32), for flooding the rebuild
//     accumulator (N f32), the extrinsics (num_be * Z f32, block-edge major,
//     so a block-row's extrinsics are contiguous) and, in trial mode,
//     Alice's syndrome (M bytes). The kernel allocates nothing.
//   * min(Z, 1024) threads per block; thread t owns checks t, t + blockDim,
//     ... of every block-row. A row is read twice per owned check: a first
//     pass over its edges for the two minima, the sign parity and (adaptive)
//     the decision parity, a second pass that recomputes each bit->check
//     message and writes the check->bit value, so no row degree is bounded.
//   * Order makes it exact: block-rows run in storage order with a barrier
//     between rows. Within a row each base column appears once and a
//     circulant maps distinct z to distinct bits, so a row updates without
//     atomics; the barrier also orders the block's global-memory writes.
//     Flooding starts the accumulator at the channel LLR and adds the new
//     extrinsics row by row, ((llr + e_r0) + e_r1) + ..., in base-row order;
//     its bit->check message is clamp(total - E_old) (the channel LLR itself
//     on the first iteration, unclamped, as in the reference decoder and the
//     fused kernels). Layered writes t + (val - E). Built with -fmad=false,
//     no fast math and no flush-to-zero.
//   * The channel LLR is never stored: trial mode recomputes it from Bob's
//     bit as -/+log_p, decode mode reads the caller's LLRs.
//   * Early exit per frame: non-adaptive algorithms and the layered
//     schedule test the decisions (total <= 0) after the update; the adaptive
//     pair under flooding tests the decisions before it, inside the row
//     sweep, where the same per-check mismatch picks the secondary factor,
//     and a converged frame keeps its totals. A block leaves its frame's
//     loop at convergence (block-wide __syncthreads_or), which equals the
//     TPU kernel's masked totals and the plain versions' frozen decisions.
//
// What bounds it on this card. At the flagship code (N=102400, Z=2048, 150
// block edges, 307,200 edges) one frame's state is 2.4 MB flooding and
// 2.0 MB layered, far beyond a block's 227 KB of shared memory, and the
// card holds at most two such blocks per SM, so 264 frames' state (about
// 530 MB) cannot stay in the 50 MB L2: the decode runs from HBM. Per edge
// and iteration it reads the total and the old extrinsic, writes the new
// extrinsic and (flooding) read-modify-writes the accumulator, and the
// convergence test reads the total again: about 24 bytes per edge, 7.4 MB
// per frame and iteration flooding, against the 13 f32 operations per edge
// that min-sum needs (14 layered). That is about 0.5 operations per byte,
// far below the card's 10 f32 operations per byte of HBM rate, so the kernel
// is bound by its HBM traffic (and by the latency of its dependent loads).
// The keys, read once, are 200 KB per frame. What the design does about it:
// coalesced accesses (a thread's consecutive z read consecutive addresses of
// every plane), no stored channel LLR, no initial extrinsic pass (the first
// iteration reads zeros without loading them), and per-frame exit. Blocks
// per SM: at 1024 threads, flooding is asked to fit two (32 registers, a few
// spilled), and layered keeps one (56-62 registers); on a 4096-frame
// flagship chunk, two blocks per SM made flooding faster and layered slower
// than one. Keeping the totals on chip (a thread-block cluster's distributed
// shared memory) and staging the extrinsic stream through TMA are later
// work. The SPA pair moves the same bytes: its first row loop parks each
// edge's term in the extrinsic slot that its second loop overwrites, and
// adds a tanhf, an atanhf and an IEEE division per edge and iteration on
// the SFU (MUFU), at a quarter of the f32 rate.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "spa.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLifting = 32768;
constexpr int kMaxBlockEdges = 1024;
constexpr int kMaxBaseChecks = 1024;

// What a launch decodes: LLRs and a syndrome, raw keys, or keys it draws.
enum Mode { kDecode = 0, kTrial = 1, kMc = 2 };

struct Params {
  const int8_t* alice;    // trial: [B, N] 0/1
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr;       // decode: [B, N]
  const int8_t* syn;      // decode: [B, M] 0/1
  const int32_t* table;   // row_ptr[mb+1], cols[num_be], shifts[num_be]
  float* scratch;         // [grid, per_block] f32
  long long per_block;    // scratch floats per block
  int mb, nb, z, num_be, batch, max_iter, use_threshold, mode;
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

__device__ __forceinline__ int bit_index(int c, int s, int z, int Z) {
  int j = z + s;
  if (j >= Z) j -= Z;
  return c * Z + j;
}

// The channel LLR of bit j of the frame at offset fo: +-log_p from Bob's key
// (the caller's, or in mc mode the slice's plane bob_mc), or the caller's LLR.
template <bool MC>
__device__ __forceinline__ float channel_llr(const Params& p,
                                             const int8_t* bob_mc, size_t fo,
                                             int j) {
  if constexpr (MC) return bob_mc[j] == 1 ? -p.log_p : p.log_p;
  if (p.mode != kDecode) return p.bob[fo + j] == 1 ? -p.log_p : p.log_p;
  return p.llr[fo + j];
}

// Bit->check message of one edge from its total t and old extrinsic eo.
template <bool LAYERED>
__device__ __forceinline__ float message(float t, float eo, int it,
                                         const Params& p) {
  if (LAYERED) return t - eo;
  return it == 0 ? t : clamp_msg(t - eo, p);
}

template <bool OFFSET>
__device__ __forceinline__ float minsum_value(float mm, float min1, float min2,
                                              float row_sign, float f) {
  float av = fabsf(mm);
  float excl = mm > 0.f ? 1.f : -1.f;
  float eabs = (av == min1) ? min2 : min1;
  if (OFFSET) return row_sign * excl * max_nan(eabs - f, 0.f);
  return f * row_sign * excl * eabs;
}

__host__ __device__ inline int table_ints(int mb, int num_be) {
  return mb + 1 + 2 * num_be;
}

// Rows of Z floats in a slice's extrinsic region: one per block edge and,
// in mc mode, at least one per base column, so that the sort keys fit there.
__host__ __device__ inline int ext_rows(int nb, int num_be, bool mc) {
  return mc && nb > num_be ? nb : num_be;
}

// Scratch floats of one block: the totals, flooding's accumulator, the
// extrinsics, then Alice's syndrome (M bytes; trial and mc) and, in mc mode,
// Alice's and Bob's key planes (N bytes each).
size_t scratch_floats(int mb, int nb, int z, int num_be, bool layered,
                      int mode) {
  const size_t n = (size_t)nb * z, m = (size_t)mb * z;
  size_t floats =
      (layered ? 1 : 2) * n + (size_t)ext_rows(nb, num_be, mode == kMc) * z;
  if (mode != kDecode) floats += (m + (mode == kMc ? 2 * n : 0) + 3) / 4;
  return (floats + 31) / 32 * 32;  // 128-byte aligned slices
}

// Dynamic shared memory of one block: the block-edge table and, in mc mode,
// the selection state.
size_t shared_bytes(int mb, int num_be, bool mc) {
  return sizeof(int) * table_ints(mb, num_be) + (mc ? sizeof(Selection) : 0);
}

// The mc mode's prologue for frame f (chunk frame d.frame0 + f): Alice's key
// plane and the sort keys (in the extrinsic region, free until the first
// sweep writes it) from the counter, the exact selection of the num_errors
// smallest keys, and Bob's key plane. The decode then reads the two planes
// as trial mode reads the caller's keys.
__device__ void mc_prologue(const Params& p, const McDraw& d, int f,
                            uint32_t* keys, int8_t* alice, int8_t* bob,
                            Selection& sel) {
  const int N = p.nb * p.z, T = blockDim.x, tid = threadIdx.x;
  const int frame = d.frame0 + f;
  for (int j = tid; j < N; j += T) {
    alice[j] = (int8_t)mc_alice(d.key, j, frame);
    keys[j] = mc_sort_key(d.key, j, frame, d.idx_bits);
  }
  __syncthreads();
  uint32_t kth = 0;
  if (d.num_errors > 0)
    kth = kth_smallest(
        [&](auto visit) {
          for (int j = tid; j < N; j += T) visit(keys[j]);
        },
        d.num_errors, sel);
  for (int j = tid; j < N; j += T)
    bob[j] = (int8_t)(alice[j] ^ (d.num_errors > 0 && keys[j] <= kth));
  __syncthreads();
}

// Blocks per SM the compiler is asked to fit by registers: two flooding,
// one layered (see the note at the top of this file). MC: the mc mode (d:
// what it draws from; unused by the other modes), compiled apart so that its
// prologue's registers do not weigh on the other modes; the same bounds give
// it the same blocks per SM. CHECK: the check update (spa.cuh: kMinSum, or
// the SPA pair, which floods), a template flag so that the min-sum
// instantiations keep their code.
template <bool LAYERED, bool ADAPTIVE, bool OFFSET, bool MC, int CHECK>
__global__ void __launch_bounds__(kMaxThreads, LAYERED ? 1 : 2)
    qc_stream_kernel(Params p, McDraw d) {
  extern __shared__ int table[];
  const int Z = p.z, mb = p.mb, nb = p.nb, num_be = p.num_be;
  const int N = nb * Z;
  const size_t M = (size_t)mb * Z;
  const int T = blockDim.x, tid = threadIdx.x;
  const int* row_ptr = table;
  const int* cols = row_ptr + mb + 1;
  const int* shifts = cols + num_be;
  for (int i = tid; i < table_ints(mb, num_be); i += T)
    table[i] = p.table[i];
  __syncthreads();

  float* const base = p.scratch + (size_t)blockIdx.x * (size_t)p.per_block;
  float* const ext = base + (LAYERED ? 1 : 2) * (size_t)N;
  int8_t* const syn_scratch =
      reinterpret_cast<int8_t*>(ext + (size_t)ext_rows(nb, num_be, MC) * Z);
  int8_t* const alice_mc = syn_scratch + M;  // mc: Alice's key plane
  int8_t* const bob_mc = alice_mc + N;       // mc: Bob's key plane

  for (int f = blockIdx.x; f < p.batch; f += gridDim.x) {
    const size_t fo = (size_t)f * N;
    float* tot = base;
    float* acc = base + N;  // flooding's rebuild accumulator
    if constexpr (MC)
      mc_prologue(
          p, d, f, reinterpret_cast<uint32_t*>(ext), alice_mc, bob_mc,
          *reinterpret_cast<Selection*>(table + table_ints(mb, num_be)));
    for (int j = tid; j < N; j += T) tot[j] = channel_llr<MC>(p, bob_mc, fo, j);
    const int8_t* syn;
    if (p.mode != kDecode) {
      for (int r = 0; r < mb; ++r)
        for (int z = tid; z < Z; z += T) {
          int bit = 0;
          for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
            const int j = bit_index(cols[e], shifts[e], z, Z);
            if constexpr (MC) {
              bit ^= alice_mc[j] & 1;
            } else {
              bit ^= p.alice[fo + j] & 1;
            }
          }
          syn_scratch[(size_t)r * Z + z] = (int8_t)bit;
        }
      syn = syn_scratch;  // each thread reads back only its own checks
    } else {
      syn = p.syn + (size_t)f * M;
    }
    __syncthreads();

    int converged = 0;
    int iters = p.max_iter;
    for (int it = 0; it < p.max_iter; ++it) {
      if (!LAYERED) {
        for (int j = tid; j < N; j += T)
          acc[j] = channel_llr<MC>(p, bob_mc, fo, j);
        __syncthreads();
      }
      int unsatisfied = 0;  // adaptive flooding: decisions before the update
      for (int r = 0; r < mb; ++r) {
        const int b = row_ptr[r], end = row_ptr[r + 1];
        for (int z = tid; z < Z; z += T) {
          const int sbit = syn[(size_t)r * Z + z] == 1;
          if constexpr (CHECK != kMinSum) {
            // The SPA pair (flooding): each term is parked in its edge's
            // extrinsic slot until the new extrinsic replaces it.
            spa_row<CHECK>(
                end - b, sbit != 0,
                [&](int j) {
                  const int e = b + j;
                  const float t = tot[bit_index(cols[e], shifts[e], z, Z)];
                  const float eo = it ? ext[(size_t)e * Z + z] : 0.f;
                  const float th = spa_term<CHECK>(message<false>(t, eo, it, p));
                  ext[(size_t)e * Z + z] = th;
                  return th;
                },
                [&](int j) { return ext[(size_t)(b + j) * Z + z]; },
                [&](int j, float v) {
                  const int e = b + j;
                  const float val = clamp_msg(v, p);
                  acc[bit_index(cols[e], shifts[e], z, Z)] += val;
                  ext[(size_t)e * Z + z] = val;
                });
            continue;
          }
          float min1 = 0.f, min2 = FLT_MAX;
          int neg = 0, par = sbit;
          for (int e = b; e < end; ++e) {
            const float t = tot[bit_index(cols[e], shifts[e], z, Z)];
            const float eo = it ? ext[(size_t)e * Z + z] : 0.f;
            const float mm = message<LAYERED>(t, eo, it, p);
            const float av = fabsf(mm);
            if (e == b) {
              min1 = av;
            } else {
              min2 = min_nan(min2, max_nan(min1, av));
              min1 = min_nan(min1, av);
            }
            neg += mm < 0.f;
            if (ADAPTIVE) par ^= t <= 0.f;
          }
          const float row_sign =
              (sbit ? -1.f : 1.f) * ((neg & 1) == 0 ? 1.f : -1.f);
          const float fac = (ADAPTIVE && par) ? p.secondary : p.primary;
          if (ADAPTIVE) unsatisfied |= par;
          for (int e = b; e < end; ++e) {
            const int idx = bit_index(cols[e], shifts[e], z, Z);
            const float t = tot[idx];
            const float eo = it ? ext[(size_t)e * Z + z] : 0.f;
            const float val = clamp_msg(
                minsum_value<OFFSET>(message<LAYERED>(t, eo, it, p), min1,
                                     min2, row_sign, fac),
                p);
            if (LAYERED) {
              tot[idx] = t + (val - eo);
            } else {
              acc[idx] += val;
            }
            ext[(size_t)e * Z + z] = val;
          }
        }
        __syncthreads();
      }
      if (!LAYERED && ADAPTIVE) {
        // Converged on the decisions before this sweep: keep those totals.
        if (!__syncthreads_or(unsatisfied)) {
          converged = 1;
          iters = it + 1;
          break;
        }
      }
      if (!LAYERED) {
        float* swap = tot;
        tot = acc;
        acc = swap;
      }
      if (LAYERED || !ADAPTIVE) {
        int bad = 0;
        for (int r = 0; r < mb; ++r)
          for (int z = tid; z < Z; z += T) {
            int par = syn[(size_t)r * Z + z] == 1;
            for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
              par ^= tot[bit_index(cols[e], shifts[e], z, Z)] <= 0.f;
            bad |= par;
          }
        if (!__syncthreads_or(bad)) {
          converged = 1;
          iters = it + 1;
          break;
        }
      }
    }

    if (p.mode != kDecode) {
      int ok = 1;
      for (int j = tid; j < N; j += T) {
        if constexpr (MC) {
          ok &= (tot[j] <= 0.f ? 1 : 0) == (alice_mc[j] & 1);
        } else {
          ok &= (tot[j] <= 0.f ? 1 : 0) == (p.alice[fo + j] & 1);
        }
      }
      ok = __syncthreads_and(ok);
      if (tid == 0) p.keys[f] = (int8_t)ok;
    } else {
      for (int j = tid; j < N; j += T)
        p.dec_out[fo + j] = tot[j] <= 0.f ? 1 : 0;
    }
    if (tid == 0) {
      p.conv[f] = (int8_t)converged;
      p.iters[f] = iters;
    }
    __syncthreads();  // the next frame overwrites the scratch
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

int threads_for(int z) { return z < kMaxThreads ? z : kMaxThreads; }

bool shape_ok(int mb, int nb, int z, int num_be) {
  return z >= 1 && z <= kMaxLifting && num_be >= 1 &&
         num_be <= kMaxBlockEdges && mb >= 1 && mb <= kMaxBaseChecks &&
         nb >= 1 && (long long)nb * z <= INT_MAX;
}

int launch(const Params& p, int flags, int grid, cudaStream_t stream,
           const McDraw& d = McDraw{}) {
  if (!shape_ok(p.mb, p.nb, p.z, p.num_be) || p.batch < 1 || grid < 1 ||
      p.scratch == nullptr ||
      (size_t)p.per_block < scratch_floats(p.mb, p.nb, p.z, p.num_be,
                                           flags & 1, p.mode))
    return (int)cudaErrorInvalidValue;
  const bool mc = p.mode == kMc;
  const size_t smem = shared_bytes(p.mb, p.num_be, mc);
  KernelFn kernel = kernel_for(flags, mc);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<grid, threads_for(p.z), smem, stream>>>(p, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch.
int qc_stream_max_lifting() { return kMaxLifting; }
int qc_stream_max_block_edges() { return kMaxBlockEdges; }
int qc_stream_max_base_checks() { return kMaxBaseChecks; }

// Scratch floats one block needs (flags bit 0: layered; mode 0 decode, 1
// trial, 2 mc).
long long qc_stream_scratch_floats(int mb, int nb, int z, int num_be,
                                   int flags, int mode) {
  return (long long)scratch_floats(mb, nb, z, num_be, flags & 1, mode);
}

// Blocks of this configuration (mc: of the mc mode's kernel) that fit on
// the current device at once (occupancy per SM times the SM count), or a
// negative CUDA error.
int qc_stream_resident_blocks(int mb, int z, int num_be, int flags, int mc) {
  const size_t smem = shared_bytes(mb, num_be, mc != 0);
  KernelFn kernel = kernel_for(flags, mc != 0);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  int per_sm = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads_for(z), smem);
  if (err != 0) return -err;
  int device = 0, sms = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return -err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (err != 0) return -err;
  return per_sm * sms;
}

int qc_stream_trial(const int8_t* alice, const int8_t* bob, int batch,
                    const int32_t* table, int mb, int nb, int z, int num_be,
                    int flags, int use_threshold, int max_iter, float log_p,
                    float primary, float secondary, float threshold,
                    float* scratch, long long per_block, int grid,
                    int8_t* conv, int8_t* keys, int32_t* iters,
                    void* stream) {
  Params p{};
  p.alice = alice;
  p.bob = bob;
  p.table = table;
  p.scratch = scratch;
  p.per_block = per_block;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
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
                     int flags, int use_threshold, int max_iter, float primary,
                     float secondary, float threshold, float* scratch,
                     long long per_block, int grid, int8_t* dec, int8_t* conv,
                     int32_t* iters, void* stream) {
  Params p{};
  p.llr = llr;
  p.syn = syn;
  p.table = table;
  p.scratch = scratch;
  p.per_block = per_block;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
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
                 int num_be, int flags, int use_threshold, int max_iter,
                 float log_p, float primary, float secondary, float threshold,
                 float* scratch, long long per_block, int grid, int8_t* conv,
                 int8_t* keys, int32_t* iters, void* stream) {
  Params p{};
  p.table = table;
  p.scratch = scratch;
  p.per_block = per_block;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
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
