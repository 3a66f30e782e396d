// Mamba2 SSD inter-chunk state recurrence, for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::_scan_kernel (the Pallas TPU kernel
// behind ssd_state_scan). Same function: over the NC chunks of a sequence,
//   entering[c] = S_c,   S_{c+1} = decay[c] * S_c + states[c],
//   final = S_NC,
// for states (NC, B, H, N, P), decay (NC, B, H) and S_0 the initial state
// (B, H, N, P), or zero. The carry is float32; states, entering and final
// are float32 or bfloat16, decay and the initial state float32. The plain
// PyTorch version is repro_torch/kernels/ref.py::ssd_state_scan_ref.
//
// What bounds it: bytes. Each element of states is read once and each of
// entering and final written once, against one multiply and one add per
// element (0.083 ms for mamba2-1.3b's prefill, NC=16, B=4, H=64, N=128,
// P=64, float32, at 3.35 TB/s). Design: one thread owns one (b, h, n, p)
// element and walks the chunks with its carry in a register, so the carry
// never goes through device memory between chunks (what the TPU kernel
// keeps in VMEM). Neighbouring threads own neighbouring p, so every load
// and store of a warp is contiguous. decay[c, b, h] is read as a scalar
// (the threads of a warp share it; the Pallas wrapper broadcasts it to the
// full states shape, which doubles the bytes read). With no initial state
// the carry starts at zero without a read. The product and the sum are
// rounded one after the other (__fmul_rn, __fadd_rn, and -fmad=false), as
// in the plain version, so the two agree bit for bit.
//
// Plain C entry point ssd_scan_launch: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(x);
}

// total = B * H * N * P elements of one chunk; np = N * P elements of one
// (b, h) tile; bh = B * H decay entries of one chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ states,
                    const float* __restrict__ decay,
                    const float* __restrict__ init, T* __restrict__ entering,
                    T* __restrict__ final_state, int nc, long long total,
                    long long np, long long bh) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long tile = e / np;  // b * H + h
  float carry = init != nullptr ? init[e] : 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const long long at = c * total + e;
    from_float(carry, &entering[at]);
    carry = __fadd_rn(__fmul_rn(carry, decay[c * bh + tile]),
                      to_float(states[at]));
  }
  from_float(carry, &final_state[e]);
}

template <typename T>
cudaError_t launch(const void* states, const void* decay, const void* init,
                   void* entering, void* final_state, int nc,
                   long long total, long long np, long long bh,
                   cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(init), static_cast<T*>(entering),
      static_cast<T*>(final_state), nc, total, np, bh);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16 (states, entering, final). states and
// entering (NC, B, H, N, P), final (B, H, N, P), decay (NC, B, H) float32
// and init (B, H, N, P) float32 or null, all contiguous; bh = B * H and
// np = N * P.
extern "C" int ssd_scan_launch(const void* states, const void* decay,
                               const void* init, void* entering,
                               void* final_state, int nc, long long bh,
                               long long np, int dtype, void* stream) {
  if (nc <= 0 || bh <= 0 || np <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const long long total = bh * np;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(states, decay, init, entering, final_state, nc, total,
                        np, bh, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(states, decay, init, entering, final_state,
                                nc, total, np, bh, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
