// Streamed generic LDPC decoder for Hopper (sm_90a): the fused generic
// decode for codes whose per-frame state does not fit in one block's shared
// memory, such as the N=102400 alist code (M=31744, E=307,200).
//
// Replaces the four TPU kernels of qkd_ldpc_v_tpu/ops/pallas_stream.py::
// _build and the XLA while-loop that drives them (`step`, :813):
//   kernel_i :524  initial staging    -> stage_messages (generic_decode.cuh)
//   kernel_s :589  Alice's syndrome   -> alice_syndrome
//   kernel_a :303  check pass, with the decision-syndrome mismatch (early
//                  exit, adaptive factor) -> check_pass, any_unsatisfied
//   kernel_b :434  bit pass: totals, decisions, the key compare or the
//                  decision planes    -> bit_pass and the frame's end
// in trial and decode modes, for the min-sum family NMSA/OMSA/ANMSA/AOMSA
// on the flooding schedule. The while-loop becomes the in-block iteration
// loop of decode_frames, which exits per frame. The plain torch version it
// is held to, bit for bit, is ops/decoders.py::make_decoder in float32
// (wrapped by ops/generic_stream.py), as for the fused generic kernel,
// whose decode body it shares: it is generic_decode.cuh's, with the
// messages in a global scratch and no LLR plane.
//
// None of the TPU machinery crosses over: no staged [src, dst, tb, chunk,
// 128] exchange, no stream_plan.py Clos permutes, no bf16x2 transport, no
// decision bit in the mantissa, no VMEM limits or block caps. Edges are
// addressed directly through fused_generic.launch_tables; cbit and bedge
// are 1.2 MB each at N=102400 and stay in the 50 MB L2.
//
// State of one frame: the messages, E floats in check-major order, in the
// block's slice of a global scratch (grid * E floats, allocated by the
// caller); decisions (N bytes) and Alice's syndrome (M bytes) in dynamic
// shared memory, 134,144 bytes at N=102400, so one block of 1024 threads
// runs per SM. The channel LLR is not stored: trial mode forms
// +-log_p from Bob's bit at each read, decode mode reads the caller's LLR.
//
// What bounds it on this card: HBM traffic and the latency of the bit
// pass's scattered gathers msg[bedge[k]], each 4 bytes out of a 32-byte
// sector. A frame's iteration moves the message array through the check
// pass (read and write) and the bit pass (gather and scatter), about 20-30
// bytes per edge against the 13 operations min-sum needs, so the messages'
// bytes bound it long before the arithmetic does. What the design does
// about it: the LLR is not stored; the node planes (decisions, syndrome)
// are on chip; the check pass reads each check's messages as one run of
// consecutive words. It is not enough: on an H100 SXM (700 W) a 4096-frame
// chunk of the 100k alist code at QBER 0.03 (14.6 iterations) takes about
// 1.75 s, some 245x its operation bound and, at 24 bytes per edge and
// iteration, under a tenth of the HBM rate (chip_smoke.py phase 3d): one
// frame per block leaves 32 warps per SM waiting on dependent loads
// (ptxas: 32 registers, no spill).

#include "generic_decode.cuh"

namespace {

template <bool ADAPTIVE, bool OFFSET>
__global__ void __launch_bounds__(kMaxThreads) generic_stream_kernel(Params p) {
  extern __shared__ float4 smem[];
  decode_frames<ADAPTIVE, OFFSET, false, false>(
      p, reinterpret_cast<char*>(smem));
}

typedef void (*KernelFn)(Params);

// flags: bit 0 adaptive, bit 1 offset (OMSA/AOMSA).
KernelFn kernel_for(int flags) {
  switch (flags & 3) {
    case 0: return generic_stream_kernel<false, false>;
    case 1: return generic_stream_kernel<true, false>;
    case 2: return generic_stream_kernel<false, true>;
    default: return generic_stream_kernel<true, true>;
  }
}

size_t stream_shared_bytes(int n, int m) {
  return shared_bytes(n, m, 0, false, false);
}

int prepare(KernelFn kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch(const Params& p, int flags, int grid, int threads,
           cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || grid < 1 || p.batch < 1 ||
      p.scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  KernelFn kernel = kernel_for(flags);
  const size_t smem = stream_shared_bytes(p.n, p.m);
  int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (decisions and syndrome).
long long generic_stream_shared_bytes(int n, int m) {
  return (long long)stream_shared_bytes(n, m);
}

// Blocks of this configuration that fit on the current device at once
// (occupancy per SM times the SM count), or a negative CUDA error.
int generic_stream_resident_blocks(int n, int m, int flags, int threads) {
  KernelFn kernel = kernel_for(flags);
  const size_t smem = stream_shared_bytes(n, m);
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
                         float* scratch, int grid, int threads, int8_t* conv,
                         int8_t* keys, int32_t* iters, void* stream) {
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
  return launch(p, flags, grid, threads, static_cast<cudaStream_t>(stream));
}

int generic_stream_decode(const float* llr, const int8_t* syn, int batch,
                          const int32_t* table, int n, int m, int e, int flags,
                          int use_threshold, int max_iter, float primary,
                          float secondary, float threshold, float* scratch,
                          int grid, int threads, int8_t* dec, int8_t* conv,
                          int32_t* iters, void* stream) {
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
  return launch(p, flags, grid, threads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
