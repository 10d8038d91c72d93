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
// kernel from the chunk's Philox stream (philox.cuh: Alice's bits, the error
// sort keys and the exact selection of the num_errors smallest), so that
// nothing of size [B, N] touches HBM. It holds the keys in the totals plane
// until the LLRs replace them and draws Alice's bits again for the key
// compare; the selection's state takes 3 KB more shared memory.
// Rate-adapted LLRs carry the float32 maximum on shortened bits, so sums can
// overflow to inf and
// inf - inf gives NaN: min and max here propagate NaN (min_nan, max_nan),
// as torch.minimum / torch.maximum and XLA do, where fminf / fmaxf would
// drop it.
//
// Circulant convention: check-aligned index z of block edge (r, c, s) is
// bit (c, (z + s) mod Z).
//
// Design.
//   * Launch shape: grid = frames, block = Z threads. Thread z owns check z
//     of every block-row; its bit->check (flooding) or check->bit (layered)
//     messages for all num_be block edges live in a per-thread array
//     (local memory: 80 floats at the N=10240, Z=512 headline code).
//   * Bit totals (nb*Z f32) live in shared memory, plus the channel LLRs
//     for flooding, which rebuilds the totals every iteration; layered
//     updates them in place. Decisions are read from the totals
//     (total <= 0 -> 1), so no decision plane is kept. Alice's syndrome is
//     one bit per block-row in a 64-bit mask per thread. The block-edge
//     table is staged in shared memory and read by broadcast.
//   * Order makes it exact: block-rows are processed in storage order with
//     a barrier between rows. Within a row each column appears once and a
//     circulant maps distinct z to distinct bits, so a row updates the
//     totals without races, and across rows the sequential order gives the
//     llr-first association ((llr + e_r0) + e_r1) + ... in base-row order
//     that the TPU kernel's bit pass uses. Layered writes t + (val - E).
//     Built with -fmad=false, no fast math and no flush-to-zero.
//   * Early exit per frame: a block leaves its loop as soon as its frame
//     satisfies the syndrome (block-wide __syncthreads_or), with the
//     decisions of that moment, which equals the TPU kernel's frozen
//     decision planes.
//
// What bounds it on this card: per-frame shared memory (2*N*4 bytes
// flooding, N*4 layered: about 80 KB / 40 KB at the headline code, so 2
// blocks of 512 threads per SM flooding; layered fits 5 by shared memory
// and is capped at 4 by the 2048-thread SM limit). ptxas reports 32
// registers per thread, so registers do not bind; the per-thread message
// array is indexed at run time and lives in local memory (a 1 KB stack
// frame per thread, cached in L1/L2). The decode is latency bound:
// keys are read from HBM once per frame, while every iteration makes
// O(num_be) dependent shared and local accesses per thread and mb+3
// barriers. The design keeps all per-iteration state on chip and lets each
// frame leave on its own; making the message array register-resident
// (code-specialised kernels) is later work. The SPA pair's check update
// adds a tanhf, an atanhf and an IEEE division per edge and iteration,
// built from the SFU's (MUFU) exponential, logarithm and reciprocal, which
// issue at a quarter of the f32 rate; each message array slot parks its
// term between the row product and the division.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "spa.cuh"

namespace {

constexpr int kMaxZ = 1024;
constexpr int kMaxBlockEdges = 256;
constexpr int kMaxBaseChecks = 64;

enum Mode { kDecode = 0, kTrial = 1, kFrame = 2, kMc = 3 };

struct Params {
  const int8_t* alice;    // trial, frame: [B, N] 0/1
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr;       // decode, frame: [B, N]
  const int8_t* syn;      // decode: [B, M] 0/1
  const int32_t* table;   // row_ptr[mb+1], cols[num_be], shifts[num_be]
  int mb, nb, z, num_be, max_iter, use_threshold, mode;
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

__device__ __forceinline__ float clamp_msg(float x, const Params& p) {
  return p.use_threshold ? min_nan(max_nan(x, -p.threshold), p.threshold) : x;
}

__device__ __forceinline__ int bit_index(int c, int s, int z, int Z) {
  int j = z + s;
  if (j >= Z) j -= Z;
  return c * Z + j;
}

// Bit r set where check (r, z) is unsatisfied by the decisions total <= 0.
__device__ __forceinline__ unsigned long long mismatch_mask(
    const float* tot, const int* row_ptr, const int* cols, const int* shifts,
    unsigned long long syn_mask, int mb, int z, int Z) {
  unsigned long long mask = 0;
  for (int r = 0; r < mb; ++r) {
    int par = (int)((syn_mask >> r) & 1ull);
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
      par ^= tot[bit_index(cols[e], shifts[e], z, Z)] <= 0.f;
    mask |= (unsigned long long)par << r;
  }
  return mask;
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

// The mc mode's prologue: Alice's bits and the errors of the block's frame
// (chunk frame d.frame0 + block), drawn from the counter at the thread's
// positions c*Z + z. Until the LLRs
// replace it, the plane `tot` holds each position's sort key with Alice's
// bit in its position field (the index gives the position back). Returns
// the thread's row mask of Alice's syndrome, and leaves the channel LLRs
// +-log_p of Bob's bits (Alice's, flipped at the num_errors smallest keys)
// in tot and, flooding, in llr.
template <bool LAYERED>
__device__ unsigned long long mc_prologue(const Params& p, const McDraw& d,
                                          const int* row_ptr, const int* cols,
                                          const int* shifts, float* tot,
                                          float* llr, Selection& sel) {
  const int Z = p.z, z = threadIdx.x, nb = p.nb, mb = p.mb;
  const int frame = d.frame0 + (int)blockIdx.x;
  const uint32_t low = mc_low_mask(d.idx_bits);
  uint32_t* held = reinterpret_cast<uint32_t*>(tot);
  for (int c = 0; c < nb; ++c) {
    const int j = c * Z + z;
    held[j] = (mc_sort_key(d.key, j, frame, d.idx_bits) & ~low) |
              (uint32_t)mc_alice(d.key, j, frame);
  }
  __syncthreads();  // the keys, and the block-edge table
  uint32_t kth = 0;
  if (d.num_errors > 0)
    kth = kth_smallest(
        [&](auto visit) {
          for (int c = 0; c < nb; ++c) {
            const int j = c * Z + z;
            visit((held[j] & ~low) | (uint32_t)j);
          }
        },
        d.num_errors, sel);
  unsigned long long syn_mask = 0;
  for (int r = 0; r < mb; ++r) {
    unsigned bit = 0;
    for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
      bit ^= held[bit_index(cols[e], shifts[e], z, Z)] & 1u;
    syn_mask |= (unsigned long long)bit << r;
  }
  __syncthreads();  // every thread has read Alice's bits
  for (int c = 0; c < nb; ++c) {
    const int j = c * Z + z;
    const uint32_t h = held[j];
    const bool flip = d.num_errors > 0 && ((h & ~low) | (uint32_t)j) <= kth;
    const float v = ((h & 1u) != 0) != flip ? -p.log_p : p.log_p;
    tot[j] = v;
    if (!LAYERED) llr[j] = v;
  }
  __syncthreads();
  return syn_mask;
}

// MC: the mc mode (d: what it draws from; unused by the other modes),
// compiled apart so that its prologue's registers do not weigh on the other
// modes. CHECK: the check update (spa.cuh: kMinSum, or the SPA pair, which
// floods), a template flag so that the min-sum instantiations keep their
// code.
template <bool LAYERED, bool ADAPTIVE, bool OFFSET, bool MC, int CHECK>
__global__ void __launch_bounds__(kMaxZ) fused_qc_kernel(Params p, McDraw d) {
  extern __shared__ int smem[];
  const int Z = p.z, mb = p.mb, nb = p.nb, num_be = p.num_be;
  const int N = nb * Z;
  const int z = threadIdx.x;
  const size_t frame = blockIdx.x;
  int* row_ptr = smem;
  int* cols = row_ptr + mb + 1;
  int* shifts = cols + num_be;
  float* tot = reinterpret_cast<float*>(shifts + num_be);
  float* llr = tot + N;  // flooding only

  for (int i = z; i < mb + 1 + 2 * num_be; i += Z) smem[i] = p.table[i];
  unsigned long long syn_mask = 0;
  if constexpr (MC) {
    syn_mask = mc_prologue<LAYERED>(
        p, d, row_ptr, cols, shifts, tot, llr,
        *reinterpret_cast<Selection*>(tot + (LAYERED ? 1 : 2) * N));
  } else {
    for (int c = 0; c < nb; ++c) {
      const int j = c * Z + z;
      float v;
      if (p.mode == kTrial) {
        v = p.bob[frame * N + j] == 1 ? -p.log_p : p.log_p;
      } else {
        v = p.llr[frame * N + j];
      }
      tot[j] = v;
      if (!LAYERED) llr[j] = v;
    }
    __syncthreads();
    for (int r = 0; r < mb; ++r) {
      int bit = 0;
      if (p.mode != kDecode) {
        for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
          bit ^= p.alice[frame * N + bit_index(cols[e], shifts[e], z, Z)] & 1;
      } else {
        bit = p.syn[frame * (size_t)(mb * Z) + r * Z + z] == 1;
      }
      syn_mask |= (unsigned long long)bit << r;
    }
  }

  // Flooding: bit->check messages (channel LLRs at first); layered:
  // check->bit extrinsics (zero before the first sweep).
  float msg[kMaxBlockEdges];
  for (int e = 0; e < num_be; ++e)
    msg[e] = LAYERED ? 0.f : tot[bit_index(cols[e], shifts[e], z, Z)];

  int converged = 0;
  int iters = p.max_iter;
  for (int it = 0; it < p.max_iter; ++it) {
    if (LAYERED) {
      for (int r = 0; r < mb; ++r) {
        const int b = row_ptr[r], end = row_ptr[r + 1];
        const int sbit = (int)((syn_mask >> r) & 1ull);
        float min1 = 0.f, min2 = FLT_MAX;
        int neg = 0, par = sbit;
        for (int e = b; e < end; ++e) {
          const float t = tot[bit_index(cols[e], shifts[e], z, Z)];
          const float mm = t - msg[e];
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
        const float f = (ADAPTIVE && par) ? p.secondary : p.primary;
        for (int e = b; e < end; ++e) {
          const int idx = bit_index(cols[e], shifts[e], z, Z);
          const float t = tot[idx];
          const float mm = t - msg[e];
          const float val =
              clamp_msg(minsum_value<OFFSET>(mm, min1, min2, row_sign, f), p);
          tot[idx] = t + (val - msg[e]);
          msg[e] = val;
        }
        __syncthreads();
      }
      const unsigned long long mism =
          mismatch_mask(tot, row_ptr, cols, shifts, syn_mask, mb, z, Z);
      if (!__syncthreads_or(mism != 0)) {
        converged = 1;
        iters = it + 1;
        break;
      }
    } else {
      unsigned long long factor_rows = 0;
      if (ADAPTIVE) {
        // Convergence on the previous decisions; the same per-check
        // mismatch picks the factor.
        factor_rows =
            mismatch_mask(tot, row_ptr, cols, shifts, syn_mask, mb, z, Z);
        if (!__syncthreads_or(factor_rows != 0)) {
          converged = 1;
          iters = it + 1;
          break;
        }
      }
      // Check pass: bit->check messages -> check->bit extrinsics.
      for (int r = 0; r < mb; ++r) {
        const int b = row_ptr[r], end = row_ptr[r + 1];
        const int sbit = (int)((syn_mask >> r) & 1ull);
        if constexpr (CHECK != kMinSum) {
          // The SPA pair: each message is parked as its term.
          spa_row<CHECK>(
              end - b, sbit != 0,
              [&](int j) { return msg[b + j] = spa_term<CHECK>(msg[b + j]); },
              [&](int j) { return msg[b + j]; },
              [&](int j, float v) { msg[b + j] = clamp_msg(v, p); });
          continue;
        }
        float min1 = 0.f, min2 = FLT_MAX;
        int neg = 0;
        for (int e = b; e < end; ++e) {
          const float av = fabsf(msg[e]);
          if (e == b) {
            min1 = av;
          } else {
            min2 = min_nan(min2, max_nan(min1, av));
            min1 = min_nan(min1, av);
          }
          neg += msg[e] < 0.f;
        }
        const float row_sign =
            (sbit ? -1.f : 1.f) * ((neg & 1) == 0 ? 1.f : -1.f);
        const float f =
            (ADAPTIVE && ((factor_rows >> r) & 1ull)) ? p.secondary : p.primary;
        for (int e = b; e < end; ++e)
          msg[e] = clamp_msg(
              minsum_value<OFFSET>(msg[e], min1, min2, row_sign, f), p);
      }
      // Bit pass: totals llr-first in base-row order, then new messages.
      __syncthreads();
      for (int c = 0; c < nb; ++c) tot[c * Z + z] = llr[c * Z + z];
      __syncthreads();
      for (int r = 0; r < mb; ++r) {
        for (int e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
          tot[bit_index(cols[e], shifts[e], z, Z)] += msg[e];
        __syncthreads();
      }
      for (int e = 0; e < num_be; ++e)
        msg[e] = clamp_msg(tot[bit_index(cols[e], shifts[e], z, Z)] - msg[e], p);
      if (!ADAPTIVE) {
        const unsigned long long mism =
            mismatch_mask(tot, row_ptr, cols, shifts, syn_mask, mb, z, Z);
        if (!__syncthreads_or(mism != 0)) {
          converged = 1;
          iters = it + 1;
          break;
        }
      }
    }
  }

  if (p.mode != kDecode) {
    int ok = 1;
    for (int c = 0; c < nb; ++c) {
      const int j = c * Z + z;
      if constexpr (MC) {
        ok &= (tot[j] <= 0.f ? 1 : 0) ==
              mc_alice(d.key, j, d.frame0 + (int)frame);
      } else {
        ok &= (tot[j] <= 0.f ? 1 : 0) == (p.alice[frame * N + j] & 1);
      }
    }
    ok = __syncthreads_and(ok);
    if (z == 0) p.keys[frame] = (int8_t)ok;
  } else {
    for (int c = 0; c < nb; ++c) {
      const int j = c * Z + z;
      p.dec_out[frame * N + j] = tot[j] <= 0.f ? 1 : 0;
    }
  }
  if (z == 0) {
    p.conv[frame] = (int8_t)converged;
    p.iters[frame] = iters;
  }
}

template <bool LAYERED, bool ADAPTIVE, bool OFFSET, int CHECK = kMinSum>
int launch(const Params& p, const McDraw& d, int batch, cudaStream_t stream) {
  const bool mc = p.mode == kMc;
  const size_t table_bytes = sizeof(int) * (p.mb + 1 + 2 * p.num_be);
  const size_t plane_bytes = sizeof(float) * (size_t)p.nb * p.z;
  const size_t smem = table_bytes + (LAYERED ? 1 : 2) * plane_bytes +
                      (mc ? sizeof(Selection) : 0);
  auto kernel = mc ? fused_qc_kernel<LAYERED, ADAPTIVE, OFFSET, true, CHECK>
                   : fused_qc_kernel<LAYERED, ADAPTIVE, OFFSET, false, CHECK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, p.z, smem, stream>>>(p, d);
  return (int)cudaGetLastError();
}

// flags: bit 0 layered, bit 1 adaptive, bit 2 offset (OMSA/AOMSA), bits 3-4
// the check update (8 SPA, 16 SPA-lin; flooding, neither adaptive nor
// offset).
int dispatch(const Params& p, int batch, int flags, cudaStream_t stream,
             const McDraw& d = McDraw{}) {
  const int check = (flags >> 3) & 3;
  if (p.z < 1 || p.z > kMaxZ || p.num_be > kMaxBlockEdges ||
      p.mb > kMaxBaseChecks || batch < 1 || check > kSpaLin ||
      (check != kMinSum && (flags & 7) != 0))
    return (int)cudaErrorInvalidValue;
  if (check == kSpa) return launch<false, false, false, kSpa>(p, d, batch, stream);
  if (check == kSpaLin)
    return launch<false, false, false, kSpaLin>(p, d, batch, stream);
  switch (flags & 7) {
    case 0: return launch<false, false, false>(p, d, batch, stream);
    case 1: return launch<true, false, false>(p, d, batch, stream);
    case 2: return launch<false, true, false>(p, d, batch, stream);
    case 3: return launch<true, true, false>(p, d, batch, stream);
    case 4: return launch<false, false, true>(p, d, batch, stream);
    case 5: return launch<true, false, true>(p, d, batch, stream);
    case 6: return launch<false, true, true>(p, d, batch, stream);
    default: return launch<true, true, true>(p, d, batch, stream);
  }
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch.
int fused_qc_max_lifting() { return kMaxZ; }
int fused_qc_max_block_edges() { return kMaxBlockEdges; }
int fused_qc_max_base_checks() { return kMaxBaseChecks; }

int fused_qc_trial(const int8_t* alice, const int8_t* bob, int batch,
                   const int32_t* table, int mb, int nb, int z, int num_be,
                   int flags, int use_threshold, int max_iter, float log_p,
                   float primary, float secondary, float threshold,
                   int8_t* conv, int8_t* keys, int32_t* iters, void* stream) {
  Params p{};
  p.alice = alice;
  p.bob = bob;
  p.table = table;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
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
  return dispatch(p, batch, flags, static_cast<cudaStream_t>(stream));
}

int fused_qc_decode(const float* llr, const int8_t* syn, int batch,
                    const int32_t* table, int mb, int nb, int z, int num_be,
                    int flags, int use_threshold, int max_iter, float primary,
                    float secondary, float threshold, int8_t* dec,
                    int8_t* conv, int32_t* iters, void* stream) {
  Params p{};
  p.llr = llr;
  p.syn = syn;
  p.table = table;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = kDecode;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.dec_out = dec;
  p.conv = conv;
  p.iters = iters;
  return dispatch(p, batch, flags, static_cast<cudaStream_t>(stream));
}

// Bytes of the mc mode's selection state in shared memory.
int mc_selection_bytes() { return (int)sizeof(Selection); }

int fused_qc_mc(unsigned k0, unsigned k1, int frame0, int num_errors,
                int batch, const int32_t* table, int mb, int nb, int z,
                int num_be, int flags, int use_threshold, int max_iter,
                float log_p, float primary, float secondary, float threshold,
                int8_t* conv, int8_t* keys, int32_t* iters, void* stream) {
  Params p{};
  p.table = table;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
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
  return dispatch(p, batch, flags, static_cast<cudaStream_t>(stream), d);
}

int fused_qc_frame(const int8_t* alice, const float* llr, int batch,
                   const int32_t* table, int mb, int nb, int z, int num_be,
                   int flags, int use_threshold, int max_iter, float primary,
                   float secondary, float threshold, int8_t* conv,
                   int8_t* keys, int32_t* iters, void* stream) {
  Params p{};
  p.alice = alice;
  p.llr = llr;
  p.table = table;
  p.mb = mb;
  p.nb = nb;
  p.z = z;
  p.num_be = num_be;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = kFrame;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.conv = conv;
  p.keys = keys;
  p.iters = iters;
  return dispatch(p, batch, flags, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
