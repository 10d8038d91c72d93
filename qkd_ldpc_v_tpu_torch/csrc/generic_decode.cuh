// Per-edge steps shared by the fused generic kernel (csrc/fused_generic.cu)
// and the streamed generic kernel (csrc/generic_stream.cu), and the fused
// kernel's decode body. Both decode an arbitrary sparse parity-check matrix
// from raw keys (trial mode) or from LLRs and a syndrome (decode mode), for
// the min-sum family NMSA/OMSA/ANMSA/AOMSA and the SPA pair (SPA,
// SPA-lin-approx: the check update of spa.cuh) on the flooding schedule. The
// fused kernel also decodes rate-adapted frames (frame mode): the caller's
// LLRs as in decode mode, Alice's syndrome and the key compare from Alice's
// frame as in trial mode; and it draws its own keys (mc mode): internal bit
// i takes the Philox stream's bits of its external position bit_ext[i]
// (philox.cuh), so that the mc modes of all three kernels share one channel,
// ops/channel.py::mc_channel.
//
// Both kernels call the same helpers for the channel LLR (input_llr,
// llr_of_bit), the two-minimum chain (two_min), the row sign (row_sign_of),
// the min-sum value (minsum_value), the clamp (clamp_msg) and the
// decision-syndrome mismatch (mismatch), so they keep one f32 association
// (llr-first totals in slot order; the min-sum value as
// f * row_sign * excl * eabs or row_sign * excl * max(eabs - f, 0)) and
// cannot drift apart. The fused
// kernel decodes one frame per block with decode_frames below; the streamed
// kernel decodes a group of frames per block in a batch-minor layout of its
// own (generic_stream.cu).
//
// decode_frames keeps the channel LLRs (N f32), the decisions (N bytes) and
// Alice's syndrome (M bytes) in shared memory, the messages there too when
// MSG_SHARED, else in the caller's global scratch (E floats per block), and
// in mc mode the selection state after them.
//
// Edges are addressed directly through index tables built on the host from
// models/layout.py::EdgeLayout, in its internal (degree-sorted) node order:
//   cptr[M+1]   check-major edge offsets of each internal check
//   cbit[E]     internal bit of each check-major edge
//   bptr[N+1]   bit-major edge offsets of each internal bit
//   bedge[E]    check-major position of each bit-major edge (to_bit_major)
//   bit_ext[N]  external index of each internal bit (bit_order)
//   chk_ext[M]  external index of each internal check (check_order)
//
// Exactness: each bit total is the channel LLR first, then its check->bit
// messages in slot order (ascending check index), added one by one; the
// min-sum value is +-1 sign logic and one multiply or one subtraction;
// sources are built with -fmad=false, no fast math and no flush-to-zero.
// Rate-adapted LLRs carry the float32 maximum on shortened bits, so sums
// can overflow to inf, and inf - inf gives NaN. With the NONFINITE flag of
// the helpers the fused kernel follows the plain decoder (and JAX's XLA
// decoder) there: min and max propagate NaN as torch.minimum /
// torch.maximum do (PTX min.NaN / max.NaN), and where every |message| of a
// check is inf the second minimum is inf too (the plain decoder's tie rule;
// the chain's second minimum starts at the float32 maximum and would stay
// there). The streamed kernel takes the same NONFINITE helpers.
// Early exit per frame: the non-adaptive algorithms test the decisions
// after the bit pass; the adaptive pair tests the previous decisions before
// the check pass, and the same per-check mismatch picks the secondary
// factor. A frame leaves its loop at convergence with the decisions of that
// moment, which equals the plain decoder's frozen decisions.
//
// The code has internal linkage in each source that includes it.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "spa.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// What a launch decodes: raw keys (trial), LLRs and a syndrome (decode),
// Alice's rate-adapted frame and its LLRs (frame; fused kernel only), or keys
// it draws itself (mc; fused kernel only).
enum Mode { kDecode = 0, kTrial = 1, kFrame = 2, kMc = 3 };

struct Params {
  const int8_t* alice;    // trial, frame: [B, N] 0/1, external order
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr_in;    // decode, frame: [B, N]
  const int8_t* syn_in;   // decode: [B, M] 0/1
  const int32_t* table;   // cptr, cbit, bptr, bedge, bit_ext, chk_ext
  float* scratch;         // the caller's global scratch (per-block slices)
  int n, m, e, batch, max_iter, use_threshold, mode;
  float log_p, primary, secondary, threshold;
  int8_t* dec_out;        // decode: [B, N]
  int8_t* conv;           // [B]
  int8_t* keys;           // trial, frame, mc: [B]
  int32_t* iters;         // [B]
};

struct Tables {
  const int* cptr;
  const int* cbit;
  const int* bptr;
  const int* bedge;
  const int* bit_ext;
  const int* chk_ext;
};

__device__ __forceinline__ Tables tables_of(const Params& p) {
  Tables t;
  t.cptr = p.table;
  t.cbit = t.cptr + p.m + 1;
  t.bptr = t.cbit + p.e;
  t.bedge = t.bptr + p.n + 1;
  t.bit_ext = t.bedge + p.e;
  t.chk_ext = t.bit_ext + p.n;
  return t;
}

// f32 min and max; with NONFINITE they return NaN where either operand is
// NaN, else they drop a NaN operand as fminf / fmaxf do.
template <bool NONFINITE>
__device__ __forceinline__ float min_of(float a, float b) {
  if (!NONFINITE) return fminf(a, b);
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool NONFINITE>
__device__ __forceinline__ float max_of(float a, float b) {
  if (!NONFINITE) return fmaxf(a, b);
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool NONFINITE = false>
__device__ __forceinline__ float clamp_msg(float x, const Params& p) {
  if (!p.use_threshold) return x;
  return min_of<NONFINITE>(max_of<NONFINITE>(x, -p.threshold), p.threshold);
}

// Where internal check c is unsatisfied by the decisions: 1 or 0 for planes
// of one frame (int8_t), a mask of frames for bit-packed planes (bit f =
// frame f).
template <typename T>
__device__ __forceinline__ int mismatch(int c, const int* cptr, const int* cbit,
                                        const T* dec, const T* syn) {
  int par = syn[c];
  for (int k = cptr[c]; k < cptr[c + 1]; ++k) par ^= dec[cbit[k]];
  return par;
}

// One step of the two-minimum chain over a check's |messages|, in slot
// order: a tie at the minimum makes min2 == min1.
template <bool NONFINITE = false>
__device__ __forceinline__ void two_min(float av, bool first, float& min1,
                                        float& min2) {
  if (first) {
    min1 = av;
  } else {
    min2 = min_of<NONFINITE>(min2, max_of<NONFINITE>(min1, av));
    min1 = min_of<NONFINITE>(min1, av);
  }
}

// The second minimum of a check of `degree` edges once the chain is done:
// with NONFINITE, inf where every |message| is inf (degree >= 2), as the
// plain decoder's tie at the minimum gives.
template <bool NONFINITE>
__device__ __forceinline__ float last_min2(int degree, float min1,
                                           float min2) {
  return (NONFINITE && degree >= 2 && isinf(min1)) ? min1 : min2;
}

// The sign of a check's product: its syndrome bit times the parity of its
// negative messages.
__device__ __forceinline__ float row_sign_of(bool syn, int neg) {
  return (syn ? -1.f : 1.f) * ((neg & 1) == 0 ? 1.f : -1.f);
}

template <bool OFFSET, bool NONFINITE = false>
__device__ __forceinline__ float minsum_value(float mm, float min1, float min2,
                                              float row_sign, float f) {
  const float excl = mm > 0.f ? 1.f : -1.f;
  const float eabs = (fabsf(mm) == min1) ? min2 : min1;
  if (OFFSET) return row_sign * excl * max_of<NONFINITE>(eabs - f, 0.f);
  return f * row_sign * excl * eabs;
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// Dynamic shared memory of one fused block: the LLR plane, decisions,
// syndrome, then the messages at a 16-byte boundary when they are shared,
// then in mc mode the selection state at a 16-byte boundary (the other
// modes do not reserve it).
__host__ __device__ inline size_t shared_bytes(int n, int m, int e,
                                               bool msg_shared, bool mc) {
  size_t bytes = align16(sizeof(float) * (size_t)n + (size_t)n + (size_t)m);
  if (msg_shared) bytes += sizeof(float) * (size_t)e;
  if (mc) bytes = align16(bytes) + sizeof(Selection);
  return bytes;
}

// The channel LLR in trial mode, from whether Bob's bit is 1.
__device__ __forceinline__ float llr_of_bit(const Params& p, bool one) {
  return one ? -p.log_p : p.log_p;
}

// The channel LLR of internal bit i of the frame whose keys or LLRs start
// at `row`, formed from the inputs: +-log_p from Bob's bit in trial mode,
// the caller's LLR in decode and frame mode.
__device__ __forceinline__ float input_llr(const Params& p, const Tables& t,
                                           size_t row, int i) {
  const int j = t.bit_ext[i];
  if (p.mode == kTrial) return llr_of_bit(p, p.bob[row + j] == 1);
  return p.llr_in[row + j];
}

// Initial staging of check c: each edge's first bit->check message is the
// channel LLR of its bit. In trial and frame mode the same pass gathers
// Alice's bits on the check and returns their parity; one pass over the
// check's edges keeps the tables' reads at one per edge. The mc mode (MC)
// has formed Alice's syndrome already.
template <bool MC>
__device__ __forceinline__ int stage_messages(int c, const Params& p,
                                              const Tables& t,
                                              const float* llr, size_t row,
                                              float* msg) {
  int parity = 0;
  for (int k = t.cptr[c]; k < t.cptr[c + 1]; ++k) {
    const int i = t.cbit[k];
    msg[k] = llr[i];
    if (!MC && p.mode != kDecode) parity ^= p.alice[row + t.bit_ext[i]] & 1;
  }
  return parity;
}

// Alice's syndrome bit of check c: the parity of Alice's bits on the check
// in trial and frame mode, the caller's syndrome in decode mode.
__device__ __forceinline__ int8_t alice_syndrome(int c, const Params& p,
                                                 const Tables& t, int frame,
                                                 int parity) {
  if (p.mode != kDecode) return (int8_t)parity;
  return (int8_t)(p.syn_in[(size_t)frame * p.m + t.chk_ext[c]] == 1);
}

// Check pass over check c: its bit->check messages become clamped
// check->bit messages; the adaptive pair takes the secondary factor where
// the decisions leave the check unsatisfied.
template <bool ADAPTIVE, bool OFFSET>
__device__ __forceinline__ void check_pass(int c, const Params& p,
                                           const Tables& t, const int8_t* dec,
                                           const int8_t* syn, float* msg) {
  const int b = t.cptr[c], end = t.cptr[c + 1];
  float min1 = 0.f, min2 = FLT_MAX;
  int neg = 0;
  for (int k = b; k < end; ++k) {
    const float mm = msg[k];
    two_min<true>(fabsf(mm), k == b, min1, min2);
    neg += mm < 0.f;
  }
  min2 = last_min2<true>(end - b, min1, min2);
  const float row_sign = row_sign_of(syn[c] != 0, neg);
  const float f = (ADAPTIVE && mismatch(c, t.cptr, t.cbit, dec, syn))
                      ? p.secondary
                      : p.primary;
  for (int k = b; k < end; ++k)
    msg[k] = clamp_msg<true>(
        minsum_value<OFFSET, true>(msg[k], min1, min2, row_sign, f), p);
}

// Check pass over check c for the SPA pair: each bit->check message is
// parked as its term, then replaced by its clamped check->bit value.
template <int CHECK>
__device__ __forceinline__ void check_pass_spa(int c, const Params& p,
                                               const Tables& t,
                                               const int8_t* syn, float* msg) {
  float* run = msg + t.cptr[c];
  spa_row<CHECK>(
      t.cptr[c + 1] - t.cptr[c], syn[c] != 0,
      [&](int j) { return run[j] = spa_term<CHECK>(run[j]); },
      [&](int j) { return run[j]; },
      [&](int j, float v) { run[j] = clamp_msg<true>(v, p); });
}

// Bit pass over bit i: the llr-first sequential total, the decision, and
// the new bit->check messages.
__device__ __forceinline__ void bit_pass(int i, const Params& p,
                                         const Tables& t, const float* llr,
                                         int8_t* dec, float* msg) {
  const int b = t.bptr[i], end = t.bptr[i + 1];
  float tot = llr[i];
  for (int k = b; k < end; ++k) tot = tot + msg[t.bedge[k]];
  dec[i] = tot <= 0.f ? 1 : 0;
  for (int k = b; k < end; ++k) {
    const int idx = t.bedge[k];
    msg[idx] = clamp_msg<true>(tot - msg[idx], p);
  }
}

// Whether any check is unsatisfied by the decisions (block-wide).
__device__ __forceinline__ int any_unsatisfied(const Params& p, const Tables& t,
                                               const int8_t* dec,
                                               const int8_t* syn) {
  int bad = 0;
  for (int c = threadIdx.x; c < p.m; c += blockDim.x)
    bad |= mismatch(c, t.cptr, t.cbit, dec, syn);
  return __syncthreads_or(bad);
}

// The mc mode's staging of one frame (chunk frame d.frame0 + frame): Alice's
// bits and the errors drawn from the counter at each internal bit's external
// position. Until the LLRs
// replace it, the LLR plane holds each bit's sort key with Alice's bit in its
// position field (bit_ext gives the position back). Leaves Alice's syndrome
// in syn, the channel LLRs +-log_p of Bob's bits (Alice's, flipped at the
// num_errors smallest keys) in llr and the first decisions in dec.
__device__ __forceinline__ void mc_stage(const Params& p, const McDraw& d,
                                         const Tables& t, int frame,
                                         float* llr, int8_t* dec, int8_t* syn,
                                         Selection& sel) {
  const int N = p.n, M = p.m, tid = threadIdx.x, nt = blockDim.x;
  const int fr = d.frame0 + frame;
  const uint32_t low = mc_low_mask(d.idx_bits);
  uint32_t* held = reinterpret_cast<uint32_t*>(llr);
  for (int i = tid; i < N; i += nt) {
    const int j = t.bit_ext[i];
    held[i] = (mc_sort_key(d.key, j, fr, d.idx_bits) & ~low) |
              (uint32_t)mc_alice(d.key, j, fr);
  }
  __syncthreads();
  uint32_t kth = 0;
  if (d.num_errors > 0)
    kth = kth_smallest(
        [&](auto visit) {
          for (int i = tid; i < N; i += nt)
            visit((held[i] & ~low) | (uint32_t)t.bit_ext[i]);
        },
        d.num_errors, sel);
  for (int c = tid; c < M; c += nt) {
    unsigned parity = 0;
    for (int k = t.cptr[c]; k < t.cptr[c + 1]; ++k)
      parity ^= held[t.cbit[k]] & 1u;
    syn[c] = (int8_t)parity;
  }
  __syncthreads();  // every thread has read Alice's bits
  for (int i = tid; i < N; i += nt) {
    const uint32_t h = held[i];
    const bool flip =
        d.num_errors > 0 && ((h & ~low) | (uint32_t)t.bit_ext[i]) <= kth;
    const float v = llr_of_bit(p, ((h & 1u) != 0) != flip);
    llr[i] = v;
    dec[i] = v <= 0.f ? 1 : 0;
  }
}

// The fused kernel's persistent block loop: block b decodes frames b,
// b + grid, ... Threads stride over internal checks in the check steps and
// over internal bits in the bit steps; each edge has one owner in each
// pass, so neither pass races, and a barrier separates them.
// MC: the mc mode, which draws from d (launches of any other mode take
// MC = false and leave d unused). CHECK: the check update (spa.cuh).
template <bool ADAPTIVE, bool OFFSET, bool MSG_SHARED, bool MC, int CHECK>
__device__ __forceinline__ void decode_frames(const Params& p,
                                              const McDraw& d, char* smem) {
  const int N = p.n, M = p.m, E = p.e;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Tables t = tables_of(p);
  float* llr = reinterpret_cast<float*>(smem);
  int8_t* dec = reinterpret_cast<int8_t*>(smem + sizeof(float) * (size_t)N);
  int8_t* syn = dec + N;
  float* msg = MSG_SHARED
                   ? reinterpret_cast<float*>(
                         smem + shared_bytes(N, M, E, false, false))
                   : p.scratch + (size_t)blockIdx.x * E;
  Selection& sel = *reinterpret_cast<Selection*>(
      smem + shared_bytes(N, M, E, MSG_SHARED, true) - sizeof(Selection));

  for (int frame = blockIdx.x; frame < p.batch; frame += gridDim.x) {
    const size_t row = (size_t)frame * N;
    if constexpr (MC) {
      mc_stage(p, d, t, frame, llr, dec, syn, sel);
      __syncthreads();
      for (int c = tid; c < M; c += nt)
        stage_messages<true>(c, p, t, llr, row, msg);
    } else {
      for (int i = tid; i < N; i += nt) {
        const float v = input_llr(p, t, row, i);
        llr[i] = v;
        dec[i] = v <= 0.f ? 1 : 0;
      }
      __syncthreads();
      for (int c = tid; c < M; c += nt) {
        const int parity = stage_messages<false>(c, p, t, llr, row, msg);
        syn[c] = alice_syndrome(c, p, t, frame, parity);
      }
    }
    __syncthreads();

    int converged = 0;
    int iters = p.max_iter;
    for (int it = 0; it < p.max_iter; ++it) {
      if (ADAPTIVE && !any_unsatisfied(p, t, dec, syn)) {
        converged = 1;
        iters = it + 1;
        break;
      }
      for (int c = tid; c < M; c += nt) {
        if constexpr (CHECK != kMinSum) {
          check_pass_spa<CHECK>(c, p, t, syn, msg);
        } else {
          check_pass<ADAPTIVE, OFFSET>(c, p, t, dec, syn, msg);
        }
      }
      __syncthreads();
      for (int i = tid; i < N; i += nt)
        bit_pass(i, p, t, llr, dec, msg);
      __syncthreads();
      if (!ADAPTIVE && !any_unsatisfied(p, t, dec, syn)) {
        converged = 1;
        iters = it + 1;
        break;
      }
    }

    // The key compare (trial, frame; mc draws Alice's bits again) or the
    // decision planes (decode).
    if (p.mode != kDecode) {
      int ok = 1;
      for (int i = tid; i < N; i += nt) {
        if constexpr (MC) {
          ok &= dec[i] == mc_alice(d.key, t.bit_ext[i], d.frame0 + frame);
        } else {
          ok &= dec[i] == (p.alice[row + t.bit_ext[i]] & 1);
        }
      }
      ok = __syncthreads_and(ok);
      if (tid == 0) p.keys[frame] = (int8_t)ok;
    } else {
      for (int i = tid; i < N; i += nt) p.dec_out[row + t.bit_ext[i]] = dec[i];
    }
    if (tid == 0) {
      p.conv[frame] = (int8_t)converged;
      p.iters[frame] = iters;
    }
    __syncthreads();  // the next frame overwrites the node planes
  }
}

}  // namespace
