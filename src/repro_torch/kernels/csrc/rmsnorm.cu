// Fused RMSNorm over the rows of a (rows, d) matrix, for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (the Pallas TPU kernel
// behind rmsnorm). Same function:
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
// with float32 statistics, x and y float32 or bfloat16, scale float32. The
// plain PyTorch version is repro_torch/kernels/ref.py::rmsnorm_ref.
//
// What bounds it: bytes. The least time is one read of x and one write of
// y at the card's memory rate (0.020 ms for 16,384 rows of 1024 bfloat16).
// Design: one warp per row, eight rows per block. Lane l owns the row's
// V-wide vectors l, l + 32, ... (V from the wrapper: 16-byte loads when d
// allows). It starts the loads of its first K vectors together, before it
// uses any of them, and keeps them in registers, so the row is read from
// device memory once: K is the smallest of 4, 8, 16, 24 that holds the
// row (4 at d = 1024 in bf16, 16 at qwen2-7b's 3584, 24 at qwen3-32b's
// 5120). A row wider than 32 * 24 vectors keeps its first 24 per lane in
// registers and reads the rest again in the second pass, in the same
// kernel. The scale is read as V-wide float vectors (16-byte loads for V
// >= 4) from L1. The arithmetic order is the plain version's: lane l adds
// the squares of its vectors in turn, element by element; an xor-shuffle
// butterfly leaves every lane the same total (the halving tree of the 32
// lane sums); the reciprocal square root is 1 / sqrtf (both rounded as
// IEEE requires), not rsqrtf; y = (x * inv) * scale. Built with
// -fmad=false, every product and sum rounds as in the plain version, so
// the two agree bit for bit. The TPU version's block_rows tiling, chosen
// for VMEM, is not carried over.
//
// Plain C entry point rmsnorm_launch: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;  // rows per block (ref.RMSNORM_WARPS)
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

// the scale's elements [i * V, i * V + V) in as few loads as alignment
// allows (float4 for V >= 4; the wrapper aligns scale to 16 bytes)
template <int V>
__device__ __forceinline__ void load_scale(float (&s)[V],
                                           const float* __restrict__ scale,
                                           int i) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(scale + i * V + j));
      s[j] = f.x;
      s[j + 1] = f.y;
      s[j + 2] = f.z;
      s[j + 3] = f.w;
    }
  } else if constexpr (V == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(scale + i * V));
    s[0] = f.x;
    s[1] = f.y;
  } else {
    s[0] = __ldg(scale + i);
  }
}

template <typename T, int V, typename R>
__device__ __forceinline__ void add_squares(const R& raw, float& acc) {
  T v[V];
  memcpy(v, &raw, sizeof(raw));
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float f = to_float(v[j]);
    acc = acc + f * f;
  }
}

template <typename T, int V, typename R>
__device__ __forceinline__ R scaled(const R& raw, float inv,
                                    const float* __restrict__ scale, int i) {
  T v[V], out[V];
  float s[V];
  memcpy(v, &raw, sizeof(raw));
  load_scale<V>(s, scale, i);
#pragma unroll
  for (int j = 0; j < V; ++j) from_float(to_float(v[j]) * inv * s[j], &out[j]);
  R w;
  memcpy(&w, out, sizeof(w));
  return w;
}

// K: vectors per lane held in registers between the two passes
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, long long rows, int d, float eps) {
  using R = typename Raw<sizeof(T) * V>::type;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const R* xr = reinterpret_cast<const R*>(x + row * d);
  R* yr = reinterpret_cast<R*>(y + row * d);
  const int nv = d / V;

  R held[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < nv) held[k] = xr[lane + 32 * k];

  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < nv) add_squares<T, V>(held[k], acc);
  for (int i = lane + 32 * K; i < nv; i += 32) add_squares<T, V>(xr[i], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
  const float inv = 1.f / sqrtf(acc / static_cast<float>(d) + eps);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < nv) yr[i] = scaled<T, V>(held[k], inv, scale, i);
  }
  for (int i = lane + 32 * K; i < nv; i += 32)
    yr[i] = scaled<T, V>(xr[i], inv, scale, i);
}

template <typename T, int V, int K>
cudaError_t launch_k(const void* x, const void* scale, void* y,
                     long long rows, int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, V, K><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(static_cast<const T*>(x),
                                      static_cast<const float*>(scale),
                                      static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

// the smallest register budget K (vectors per lane) that holds the row
template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  const int per_lane = (d / V + 31) / 32;
  if (per_lane <= 4) return launch_k<T, V, 4>(x, scale, y, rows, d, eps, stream);
  if (per_lane <= 8) return launch_k<T, V, 8>(x, scale, y, rows, d, eps, stream);
  if (per_lane <= 16)
    return launch_k<T, V, 16>(x, scale, y, rows, d, eps, stream);
  return launch_k<T, V, 24>(x, scale, y, rows, d, eps, stream);
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16; vec is the elements per load, chosen
// by the caller (repro_torch/kernels/rmsnorm.py: vector_width) so that
// d % vec == 0 and x and y are aligned to vec elements; scale is aligned
// to 16 bytes. The launch<T, V> pairs below are exactly
// rmsnorm.VEC_WIDTHS; a CPU test checks it.
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
