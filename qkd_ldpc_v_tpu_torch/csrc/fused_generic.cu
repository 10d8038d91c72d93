// Fused generic LDPC decoder for Hopper (sm_90a): one thread block decodes
// one frame at a time of an arbitrary sparse parity-check matrix, from raw
// keys (trial mode) or from LLRs and a syndrome (decode mode) to its
// per-frame statistics or decisions.
//
// Replaces the TPU kernel qkd_ldpc_v_tpu/ops/pallas_generic.py::_build.kernel
// (trial and decode modes; the min-sum family NMSA/OMSA/ANMSA/AOMSA; the
// flooding schedule). The plain torch version it is held to, bit for bit,
// is qkd_ldpc_v_tpu_torch/ops/decoders.py::make_decoder in float32 (wrapped
// by ops/fused_generic.py).
//
// Edges are addressed directly through index tables built on the host from
// models/layout.py::EdgeLayout, in its internal (degree-sorted) node order:
//   cptr[M+1]   check-major edge offsets of each internal check
//   cbit[E]     internal bit of each check-major edge
//   bptr[N+1]   bit-major edge offsets of each internal bit
//   bedge[E]    check-major position of each bit-major edge (to_bit_major)
//   bit_ext[N]  external index of each internal bit (bit_order)
//   chk_ext[M]  external index of each internal check (check_order)
// None of the TPU kernel's transport carries over: no Clos regroup, no
// 128-lane planes, no bf16x2 packing and no decision bit in the mantissa,
// which is why this kernel is exact where the TPU kernel is only
// statistically equal to the reference decoder.
//
// Design.
//   * Launch shape: a persistent grid of at most as many blocks as fit on
//     the card at once; block b decodes frames b, b + grid, ... Threads
//     stride over internal checks in the check pass and over internal bits
//     in the bit pass.
//   * One message array per block, E floats in check-major order. The check
//     pass overwrites each check's bit->check messages with its check->bit
//     messages; the bit pass overwrites those with the new bit->check
//     messages. Each edge has one owner in each pass, so neither pass races;
//     a barrier separates them. The array lives in shared memory when it
//     fits beside the node planes (MSG_SHARED), else in a global scratch of
//     grid * E floats that the caller allocates (addressable state that a
//     larger-N mode can reuse).
//   * Shared memory also holds the channel LLRs (N f32), the decisions (N
//     bytes) and Alice's syndrome (M bytes).
//   * Order makes it exact: each bit total is the channel LLR first, then
//     its check->bit messages in its slot order (ascending check index),
//     added one by one; the min-sum value is ±1 sign logic and one multiply
//     (f * eabs) or one subtraction (eabs - f); built with -fmad=false, no
//     fast math and no flush-to-zero.
//   * Early exit per frame: the non-adaptive algorithms test the decisions
//     after the bit pass; the adaptive pair tests the previous decisions
//     before the check pass, and the same per-check mismatch picks the
//     secondary factor. A frame leaves its loop at convergence with the
//     decisions of that moment (block-wide __syncthreads_or), which equals
//     the plain decoder's frozen decisions.
//
// What bounds it on this card: the decode is latency bound. Every
// iteration makes O(E) dependent accesses per frame through the index
// tables, which do not fit in shared memory beside the messages and come
// from L2 (the 10k alist code's cbit and bedge are 160 KB each), and three
// barriers. Keys or LLRs are read once per frame. At the 10k alist code a
// block takes 217,888 bytes of shared memory, so one block of 1024 threads
// runs per SM; ptxas reports 44 registers per thread (32 and a 16-byte
// spill when the messages are global). Messages in a global
// scratch (four blocks of 512 threads per SM, 84 MB of message state
// against the 50 MB L2) were 10x slower there, so they serve only codes
// whose messages do not fit in shared memory.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

struct Params {
  const int8_t* alice;    // trial: [B, N] 0/1, external order
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr_in;    // decode: [B, N]
  const int8_t* syn_in;   // decode: [B, M] 0/1
  const int32_t* table;   // cptr, cbit, bptr, bedge, bit_ext, chk_ext
  float* scratch;         // [grid, E] when the messages are not shared
  int n, m, e, batch, max_iter, use_threshold, trial;
  float log_p, primary, secondary, threshold;
  int8_t* dec_out;        // decode: [B, N]
  int8_t* conv;           // [B]
  int8_t* keys;           // trial: [B]
  int32_t* iters;         // [B]
};

__device__ __forceinline__ float clamp_msg(float x, const Params& p) {
  return p.use_threshold ? fminf(fmaxf(x, -p.threshold), p.threshold) : x;
}

// 1 where internal check c is unsatisfied by the decisions.
__device__ __forceinline__ int mismatch(int c, const int* cptr, const int* cbit,
                                        const int8_t* dec, const int8_t* syn) {
  int par = syn[c];
  for (int k = cptr[c]; k < cptr[c + 1]; ++k) par ^= dec[cbit[k]];
  return par;
}

template <bool OFFSET>
__device__ __forceinline__ float minsum_value(float mm, float min1, float min2,
                                              float row_sign, float f) {
  const float excl = mm > 0.f ? 1.f : -1.f;
  const float eabs = (fabsf(mm) == min1) ? min2 : min1;
  if (OFFSET) return row_sign * excl * fmaxf(eabs - f, 0.f);
  return f * row_sign * excl * eabs;
}

// Dynamic shared memory of one block: LLRs, decisions, syndrome, then the
// messages at a 16-byte boundary when they are shared.
__host__ __device__ inline size_t shared_bytes(int n, int m, int e,
                                               bool msg_shared) {
  size_t bytes = sizeof(float) * (size_t)n + (size_t)n + (size_t)m;
  bytes = (bytes + 15) & ~(size_t)15;
  if (msg_shared) bytes += sizeof(float) * (size_t)e;
  return bytes;
}

template <bool ADAPTIVE, bool OFFSET, bool MSG_SHARED>
__global__ void __launch_bounds__(kMaxThreads) fused_generic_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.n, M = p.m, E = p.e;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* llr = smem;
  int8_t* dec = reinterpret_cast<int8_t*>(llr + N);
  int8_t* syn = dec + N;
  float* msg = MSG_SHARED
                   ? reinterpret_cast<float*>(
                         reinterpret_cast<char*>(smem) +
                         shared_bytes(N, M, E, false))
                   : p.scratch + (size_t)blockIdx.x * E;
  const int* cptr = p.table;
  const int* cbit = cptr + M + 1;
  const int* bptr = cbit + E;
  const int* bedge = bptr + N + 1;
  const int* bit_ext = bedge + E;
  const int* chk_ext = bit_ext + N;

  for (int frame = blockIdx.x; frame < p.batch; frame += gridDim.x) {
    const size_t row = (size_t)frame * N;
    for (int i = tid; i < N; i += nt) {
      const int j = bit_ext[i];
      float v;
      if (p.trial) {
        v = p.bob[row + j] == 1 ? -p.log_p : p.log_p;
      } else {
        v = p.llr_in[row + j];
      }
      llr[i] = v;
      dec[i] = v <= 0.f ? 1 : 0;
    }
    __syncthreads();
    // Alice's syndrome and the initial bit->check messages (the channel
    // LLR of each edge's bit).
    for (int c = tid; c < M; c += nt) {
      int bit = 0;
      for (int k = cptr[c]; k < cptr[c + 1]; ++k) {
        const int i = cbit[k];
        msg[k] = llr[i];
        if (p.trial) bit ^= p.alice[row + bit_ext[i]] & 1;
      }
      if (!p.trial) bit = p.syn_in[(size_t)frame * M + chk_ext[c]] == 1;
      syn[c] = (int8_t)bit;
    }
    __syncthreads();

    int converged = 0;
    int iters = p.max_iter;
    for (int it = 0; it < p.max_iter; ++it) {
      if (ADAPTIVE) {
        int bad = 0;
        for (int c = tid; c < M; c += nt) bad |= mismatch(c, cptr, cbit, dec, syn);
        if (!__syncthreads_or(bad)) {
          converged = 1;
          iters = it + 1;
          break;
        }
      }
      // Check pass: bit->check messages -> clamped check->bit messages.
      for (int c = tid; c < M; c += nt) {
        const int b = cptr[c], end = cptr[c + 1];
        float min1 = 0.f, min2 = FLT_MAX;
        int neg = 0;
        for (int k = b; k < end; ++k) {
          const float mm = msg[k];
          const float av = fabsf(mm);
          if (k == b) {
            min1 = av;
          } else {
            min2 = fminf(min2, fmaxf(min1, av));
            min1 = fminf(min1, av);
          }
          neg += mm < 0.f;
        }
        const float row_sign =
            (syn[c] ? -1.f : 1.f) * ((neg & 1) == 0 ? 1.f : -1.f);
        const float f =
            (ADAPTIVE && mismatch(c, cptr, cbit, dec, syn)) ? p.secondary
                                                            : p.primary;
        for (int k = b; k < end; ++k)
          msg[k] = clamp_msg(
              minsum_value<OFFSET>(msg[k], min1, min2, row_sign, f), p);
      }
      __syncthreads();
      // Bit pass: llr-first sequential totals, decisions, new messages.
      for (int i = tid; i < N; i += nt) {
        const int b = bptr[i], end = bptr[i + 1];
        float t = llr[i];
        for (int k = b; k < end; ++k) t = t + msg[bedge[k]];
        dec[i] = t <= 0.f ? 1 : 0;
        for (int k = b; k < end; ++k) {
          const int idx = bedge[k];
          msg[idx] = clamp_msg(t - msg[idx], p);
        }
      }
      __syncthreads();
      if (!ADAPTIVE) {
        int bad = 0;
        for (int c = tid; c < M; c += nt) bad |= mismatch(c, cptr, cbit, dec, syn);
        if (!__syncthreads_or(bad)) {
          converged = 1;
          iters = it + 1;
          break;
        }
      }
    }

    if (p.trial) {
      int ok = 1;
      for (int i = tid; i < N; i += nt)
        ok &= dec[i] == (p.alice[row + bit_ext[i]] & 1);
      ok = __syncthreads_and(ok);
      if (tid == 0) p.keys[frame] = (int8_t)ok;
    } else {
      for (int i = tid; i < N; i += nt) p.dec_out[row + bit_ext[i]] = dec[i];
    }
    if (tid == 0) {
      p.conv[frame] = (int8_t)converged;
      p.iters[frame] = iters;
    }
    __syncthreads();  // the next frame overwrites the node planes
  }
}

typedef void (*KernelFn)(Params);

template <bool ADAPTIVE, bool OFFSET>
KernelFn pick(bool msg_shared) {
  return msg_shared ? fused_generic_kernel<ADAPTIVE, OFFSET, true>
                    : fused_generic_kernel<ADAPTIVE, OFFSET, false>;
}

// flags: bit 0 adaptive, bit 1 offset (OMSA/AOMSA).
KernelFn kernel_for(int flags, bool msg_shared) {
  switch (flags & 3) {
    case 0: return pick<false, false>(msg_shared);
    case 1: return pick<true, false>(msg_shared);
    case 2: return pick<false, true>(msg_shared);
    default: return pick<true, true>(msg_shared);
  }
}

int prepare(KernelFn kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch(const Params& p, int flags, int msg_shared, int grid, int threads,
           cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || grid < 1 || p.batch < 1 ||
      (!msg_shared && p.scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags, msg_shared != 0);
  const size_t smem = shared_bytes(p.n, p.m, p.e, msg_shared != 0);
  int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes.
long long fused_generic_shared_bytes(int n, int m, int e, int msg_shared) {
  return (long long)shared_bytes(n, m, e, msg_shared != 0);
}

// Blocks of this configuration that fit on the current device at once
// (occupancy per SM times the SM count), or a negative CUDA error.
int fused_generic_resident_blocks(int n, int m, int e, int flags,
                                  int msg_shared, int threads) {
  KernelFn kernel = kernel_for(flags, msg_shared != 0);
  const size_t smem = shared_bytes(n, m, e, msg_shared != 0);
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

int fused_generic_trial(const int8_t* alice, const int8_t* bob, int batch,
                        const int32_t* table, int n, int m, int e, int flags,
                        int use_threshold, int max_iter, float log_p,
                        float primary, float secondary, float threshold,
                        float* scratch, int msg_shared, int grid, int threads,
                        int8_t* conv, int8_t* keys, int32_t* iters,
                        void* stream) {
  Params p{};
  p.alice = alice;
  p.bob = bob;
  p.table = table;
  p.scratch = scratch;
  p.n = n;
  p.m = m;
  p.e = e;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.trial = 1;
  p.log_p = log_p;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.conv = conv;
  p.keys = keys;
  p.iters = iters;
  return launch(p, flags, msg_shared, grid, threads,
                static_cast<cudaStream_t>(stream));
}

int fused_generic_decode(const float* llr, const int8_t* syn, int batch,
                         const int32_t* table, int n, int m, int e, int flags,
                         int use_threshold, int max_iter, float primary,
                         float secondary, float threshold, float* scratch,
                         int msg_shared, int grid, int threads, int8_t* dec,
                         int8_t* conv, int32_t* iters, void* stream) {
  Params p{};
  p.llr_in = llr;
  p.syn_in = syn;
  p.table = table;
  p.scratch = scratch;
  p.n = n;
  p.m = m;
  p.e = e;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.trial = 0;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.dec_out = dec;
  p.conv = conv;
  p.iters = iters;
  return launch(p, flags, msg_shared, grid, threads,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
