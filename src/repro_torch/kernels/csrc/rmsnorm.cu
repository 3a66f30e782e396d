// Fused RMSNorm over the rows of a (rows, d) matrix, for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (the Pallas TPU kernel
// behind rmsnorm). Same function:
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
// with float32 statistics, x and y float32 or bfloat16, scale float32. The
// plain PyTorch version is repro_torch/kernels/ref.py::rmsnorm_ref.
//
// What bounds it: bytes. Each element is read, squared and added, then read
// again (from L1/L2) and scaled, so the least time is one read of x and one
// write of y at the card's memory rate (0.020 ms for 16,384 rows of 1024
// bfloat16). Design: one warp per row, four rows per block. Lane l reads
// the row's V-wide vectors l, l + 32, ... (V from the wrapper: 16-byte
// loads when d allows), so a warp reads 32 * V contiguous elements at a
// time; it adds the squares of its elements in turn, and an xor-shuffle
// butterfly leaves every lane the same total (the halving tree of the 32
// lane sums). The row then streams again through the same lanes for the
// scaled write. The TPU version's block_rows tiling, chosen for VMEM, is
// not carried over. The reciprocal square root is 1 / sqrtf (both rounded
// as IEEE requires), not rsqrtf, and with -fmad=false every product and
// sum rounds as in the plain version, so the two agree bit for bit.
//
// Plain C entry point rmsnorm_launch: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;  // rows per block (ref.RMSNORM_WARPS)
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(x);
}

template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, long long rows, int d, float eps) {
  using R = typename Raw<sizeof(T) * V>::type;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int nv = d / V;

  float acc = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const R raw = *reinterpret_cast<const R*>(xr + i * V);
    T v[V];
    memcpy(v, &raw, sizeof(raw));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_float(v[j]);
      acc = acc + f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
  const float inv = 1.f / sqrtf(acc / static_cast<float>(d) + eps);

  for (int i = lane; i < nv; i += 32) {
    const R raw = *reinterpret_cast<const R*>(xr + i * V);
    T v[V];
    memcpy(v, &raw, sizeof(raw));
    T out[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      from_float(to_float(v[j]) * inv * scale[i * V + j], &out[j]);
    R w;
    memcpy(&w, out, sizeof(w));
    *reinterpret_cast<R*>(yr + i * V) = w;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(static_cast<const T*>(x),
                                   static_cast<const float*>(scale),
                                   static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16; vec is the elements per load, chosen
// by the caller (repro_torch/kernels/rmsnorm.py: vector_width) so that
// d % vec == 0 and x and y are aligned to vec elements. The launch<T, V>
// pairs below are exactly rmsnorm.VEC_WIDTHS; a CPU test checks it.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int d, float eps, int dtype,
                              int vec, void* stream) {
  if (rows <= 0 || d <= 0 || vec <= 0 || d % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && vec == 4) err = launch<float, 4>(x, scale, y, rows, d, eps, s);
  else if (dtype == 0 && vec == 2) err = launch<float, 2>(x, scale, y, rows, d, eps, s);
  else if (dtype == 0 && vec == 1) err = launch<float, 1>(x, scale, y, rows, d, eps, s);
  else if (dtype == 1 && vec == 8) err = launch<__nv_bfloat16, 8>(x, scale, y, rows, d, eps, s);
  else if (dtype == 1 && vec == 4) err = launch<__nv_bfloat16, 4>(x, scale, y, rows, d, eps, s);
  else if (dtype == 1 && vec == 2) err = launch<__nv_bfloat16, 2>(x, scale, y, rows, d, eps, s);
  else if (dtype == 1 && vec == 1) err = launch<__nv_bfloat16, 1>(x, scale, y, rows, d, eps, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
