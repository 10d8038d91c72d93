// Fused generic LDPC decoder for Hopper (sm_90a): one thread block decodes
// one frame at a time of an arbitrary sparse parity-check matrix, from raw
// keys (trial mode), from LLRs and a syndrome (decode mode), from a
// rate-adapted frame and its LLRs (frame mode) or from keys it draws itself
// (mc mode) to its per-frame statistics or decisions.
//
// Replaces the TPU kernel qkd_ldpc_v_tpu/ops/pallas_generic.py::_build.kernel
// (trial, decode, frame and mc modes; the min-sum family
// NMSA/OMSA/ANMSA/AOMSA and the SPA pair SPA / SPA-lin-approx; the flooding
// schedule). The plain torch version it
// is held to, bit for bit, is qkd_ldpc_v_tpu_torch/ops/decoders.py::
// make_decoder in float32 (wrapped by ops/fused_generic.py), and for the mc
// mode's keys ops/channel.py::mc_channel. The mc mode draws each bit's keys
// at its external position, not at the TPU kernel's flat, lane-padded plane
// position (generic_decode.cuh::mc_stage).
//
// The decode body, its index tables and what makes it exact are in
// csrc/generic_decode.cuh, whose per-edge steps the streamed generic kernel
// (csrc/generic_stream.cu) shares. None of the TPU kernel's transport
// carries over: no Clos regroup, no 128-lane planes, no bf16x2 packing and
// no decision bit in the mantissa, which is why this kernel is exact where
// the TPU kernel is only statistically equal to the reference decoder.
//
// Design.
//   * Launch shape: a persistent grid of at most as many blocks as fit on
//     the card at once; block b decodes frames b, b + grid, ...
//   * One message array per block, E floats in check-major order. The check
//     pass overwrites each check's bit->check messages with its check->bit
//     messages; the bit pass overwrites those with the new bit->check
//     messages. The array lives in shared memory when it fits beside the
//     node planes (MSG_SHARED), else in a global scratch of grid * E floats
//     that the caller allocates.
//   * Shared memory also holds the channel LLRs (N f32), the decisions (N
//     bytes) and Alice's syndrome (M bytes).
//
// What bounds it on this card: the decode is latency bound. Every
// iteration makes O(E) dependent accesses per frame through the index
// tables, which do not fit in shared memory beside the messages and come
// from L2 (the 10k alist code's cbit and bedge are 160 KB each), and three
// barriers. Keys or LLRs are read once per frame. At the 10k alist code a
// block takes 217,888 bytes of shared memory (the mc mode 3,092 more for its
// selection state), so one block of 1024 threads
// runs per SM; ptxas reports 32 registers per thread and no spill
// (chip_smoke.py prints it). Messages in a global
// scratch (four blocks of 512 threads per SM, 84 MB of message state
// against the 50 MB L2) were 10x slower there, so they serve only codes
// whose messages do not fit in shared memory. The SPA pair parks each term
// in its message slot between the row product and the division, and adds a
// tanhf, an atanhf and an IEEE division per edge and iteration on the SFU
// (MUFU), at a quarter of the f32 rate.

#include "generic_decode.cuh"

namespace {

// The decode body is generic_decode.cuh's decode_frames; the messages are
// shared where they fit. MC: the mc mode (d: what it draws from; unused by
// the other modes), compiled apart so that its staging's registers do not
// weigh on the other modes. CHECK: the check update (spa.cuh), a template
// flag so that the min-sum instantiations keep their code.
template <bool ADAPTIVE, bool OFFSET, bool MSG_SHARED, bool MC, int CHECK>
__global__ void __launch_bounds__(kMaxThreads)
    fused_generic_kernel(Params p, McDraw d) {
  extern __shared__ float4 smem[];
  decode_frames<ADAPTIVE, OFFSET, MSG_SHARED, MC, CHECK>(
      p, d, reinterpret_cast<char*>(smem));
}

typedef void (*KernelFn)(Params, McDraw);

template <bool ADAPTIVE, bool OFFSET, bool MC, int CHECK = kMinSum>
KernelFn pick(bool msg_shared) {
  return msg_shared ? fused_generic_kernel<ADAPTIVE, OFFSET, true, MC, CHECK>
                    : fused_generic_kernel<ADAPTIVE, OFFSET, false, MC, CHECK>;
}

template <bool MC>
KernelFn kernel_of(int flags, bool msg_shared) {
  const int check = (flags >> 2) & 3;
  if (check != kMinSum) {
    if ((flags & 3) != 0) return nullptr;
    if (check == kSpa) return pick<false, false, MC, kSpa>(msg_shared);
    if (check == kSpaLin) return pick<false, false, MC, kSpaLin>(msg_shared);
    return nullptr;
  }
  switch (flags & 3) {
    case 0: return pick<false, false, MC>(msg_shared);
    case 1: return pick<true, false, MC>(msg_shared);
    case 2: return pick<false, true, MC>(msg_shared);
    default: return pick<true, true, MC>(msg_shared);
  }
}

// flags: bit 0 adaptive, bit 1 offset (OMSA/AOMSA), bits 2-3 the check
// update (4 SPA, 8 SPA-lin; neither adaptive nor offset). nullptr for flags
// without a kernel.
KernelFn kernel_for(int flags, bool msg_shared, bool mc) {
  return mc ? kernel_of<true>(flags, msg_shared)
            : kernel_of<false>(flags, msg_shared);
}

int prepare(KernelFn kernel, size_t smem) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch(const Params& p, int flags, int msg_shared, int grid, int threads,
           cudaStream_t stream, const McDraw& d = McDraw{}) {
  if (threads < 32 || threads > kMaxThreads || grid < 1 || p.batch < 1 ||
      (!msg_shared && p.scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool mc = p.mode == kMc;
  KernelFn kernel = kernel_for(flags, msg_shared != 0, mc);
  const size_t smem = shared_bytes(p.n, p.m, p.e, msg_shared != 0, mc);
  int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, stream>>>(p, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (mc: in the mc mode).
long long fused_generic_shared_bytes(int n, int m, int e, int msg_shared,
                                     int mc) {
  return (long long)shared_bytes(n, m, e, msg_shared != 0, mc != 0);
}

// Blocks of this configuration (mc: of the mc mode's kernel) that fit on
// the current device at once (occupancy per SM times the SM count), or a
// negative CUDA error.
int fused_generic_resident_blocks(int n, int m, int e, int flags,
                                  int msg_shared, int threads, int mc) {
  KernelFn kernel = kernel_for(flags, msg_shared != 0, mc != 0);
  const size_t smem = shared_bytes(n, m, e, msg_shared != 0, mc != 0);
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
  p.mode = kTrial;
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
  p.mode = kDecode;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.dec_out = dec;
  p.conv = conv;
  p.iters = iters;
  return launch(p, flags, msg_shared, grid, threads,
                static_cast<cudaStream_t>(stream));
}

int fused_generic_mc(unsigned k0, unsigned k1, int frame0, int num_errors,
                     int batch, const int32_t* table, int n, int m, int e,
                     int flags, int use_threshold, int max_iter, float log_p,
                     float primary, float secondary, float threshold,
                     float* scratch, int msg_shared, int grid, int threads,
                     int8_t* conv, int8_t* keys, int32_t* iters,
                     void* stream) {
  Params p{};
  p.table = table;
  p.scratch = scratch;
  p.n = n;
  p.m = m;
  p.e = e;
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
  const McDraw d{McKey{k0, k1}, frame0, num_errors, mc_idx_bits(n)};
  if (num_errors < 0 || num_errors > n || frame0 < 0)
    return (int)cudaErrorInvalidValue;
  return launch(p, flags, msg_shared, grid, threads,
                static_cast<cudaStream_t>(stream), d);
}

int fused_generic_frame(const int8_t* alice, const float* llr, int batch,
                        const int32_t* table, int n, int m, int e, int flags,
                        int use_threshold, int max_iter, float primary,
                        float secondary, float threshold, float* scratch,
                        int msg_shared, int grid, int threads, int8_t* conv,
                        int8_t* keys, int32_t* iters, void* stream) {
  Params p{};
  p.alice = alice;
  p.llr_in = llr;
  p.table = table;
  p.scratch = scratch;
  p.n = n;
  p.m = m;
  p.e = e;
  p.batch = batch;
  p.max_iter = max_iter;
  p.use_threshold = use_threshold;
  p.mode = kFrame;
  p.primary = primary;
  p.secondary = secondary;
  p.threshold = threshold;
  p.conv = conv;
  p.keys = keys;
  p.iters = iters;
  return launch(p, flags, msg_shared, grid, threads,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
