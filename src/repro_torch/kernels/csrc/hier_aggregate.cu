// Eq. (8)/(14) weighted mean over a stack of client models, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/hier_aggregate.py::_agg_kernel (the Pallas TPU
// kernel behind hier_aggregate). Same function:
//   out[p] = sum_c (w[c] / max(sum_c w[c], 1e-30)) * u[c, p]
// for u (C, P) float32 or bfloat16 and w (C,) float32, accumulated in
// float32, out (P,) in u's type. The plain PyTorch version is
// repro_torch/kernels/ref.py::hier_aggregate_ref.
//
// What bounds it: bytes. Each element of u is read once and takes one
// multiply and one add, so the least time is the C*P reads and P writes at
// the card's memory rate (0.12 ms for the cloud mean of 1000 clients of a
// 101,770-parameter model). Design: each thread owns V consecutive columns
// of a tile of kThreads * V columns (the wrapper picks V from P and the
// alignment), so a warp reads 32*V contiguous elements of a row at a time.
// The C rows of a tile are split over the S blocks of one thread block
// cluster (S from (C, P) by ref.agg_splits, at most kMaxSplits, so that a
// model of 10^5 parameters still runs several blocks on every SM; S = 1,
// a plain launch, when C is too small to pay for the cluster): block
// rank q streams rows [q * rows, (q + 1) * rows) in order, its row loop
// unrolled so that several rows' loads are in flight. Each block keeps its
// float32 partial sums in shared memory; rank 0 reads the others' through
// distributed shared memory and adds them in rank order, then rounds once
// to u's type. One launch, and no partial sums pass through device memory.
// Each block first reduces all C weights itself (thread t adds w[t],
// w[t+256], ... in turn, then warp shuffles and one warp over the warp
// partials: ref.thread_block_sum) and keeps its rows' normalised weights in
// shared memory, kChunk rows at a time. The TPU version's block_p tiling,
// chosen for VMEM, is not carried over. Built with -fmad=false, each
// product and each sum rounds as in the plain version, so the two agree
// bit for bit.
//
// Plain C entry point hier_aggregate_launch: launches on the given stream,
// does not synchronise, allocates nothing, returns the launch's error.

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // ref.AGG_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;   // normalised weights in shared memory at once
constexpr int kMaxSplits = 8;  // ref.AGG_MAX_SPLITS: the portable cluster size

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(x);
}

// A register type of B bytes, so that one load or store moves V elements.
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    hier_aggregate_kernel(const T* __restrict__ u, const float* __restrict__ w,
                          T* __restrict__ out, int C, long long P, int rows) {
  using R = typename Raw<sizeof(T) * V>::type;
  __shared__ float wn[kChunk];
  __shared__ float part[kWarps];
  __shared__ float partial[kThreads * V];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

  // ---- sum of the weights, in ref.thread_block_sum's order ----
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s += w[c];
  s = warp_sum(s);
  if (lane == 0) part[wid] = s;
  __syncthreads();
  const float total =
      fmaxf(warp_sum(lane < kWarps ? part[lane] : 0.f), 1e-30f);

  // ---- stream this split's rows: this thread's V columns, in order ----
  const long long tile = blockIdx.x / splits;
  const long long col = (tile * kThreads + threadIdx.x) * V;
  const bool owns = col < P;  // P % V == 0, so the V columns all exist
  const int c_end = min(C, (rank + 1) * rows);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int c0 = rank * rows; c0 < c_end; c0 += kChunk) {
    const int n = min(kChunk, c_end - c0);
    __syncthreads();  // the previous chunk's reads of wn are done
    for (int i = threadIdx.x; i < n; i += kThreads) wn[i] = w[c0 + i] / total;
    __syncthreads();
    if (owns) {
      const T* row = u + static_cast<long long>(c0) * P + col;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const R raw = *reinterpret_cast<const R*>(row + i * P);
        T x[V];
        memcpy(x, &raw, sizeof(raw));
        const float wi = wn[i];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = acc[j] + wi * to_float(x[j]);
      }
    }
  }

  // ---- rank 0 adds the partials in rank order, through DSMEM ----
  if (splits > 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) partial[threadIdx.x * V + j] = acc[j];
    cluster.sync();
    if (rank == 0 && owns) {
      for (int q = 1; q < splits; ++q) {
        const float* other = cluster.map_shared_rank(partial, q);
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = acc[j] + other[threadIdx.x * V + j];
      }
    }
  }
  if (rank == 0 && owns) {
    T y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) from_float(acc[j], &y[j]);
    R raw;
    memcpy(&raw, y, sizeof(raw));
    *reinterpret_cast<R*>(out + col) = raw;
  }
  // each block's partials live until rank 0 has read them
  if (splits > 1) cluster.sync();
}

template <typename T, int V>
cudaError_t launch(const void* u, const void* w, void* out, int C,
                   long long P, int splits, int rows, cudaStream_t stream) {
  const long long blocks = (P / V + kThreads - 1) / kThreads * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, hier_aggregate_kernel<T, V>, static_cast<const T*>(u),
      static_cast<const float*>(w), static_cast<T*>(out), C, P, rows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16; vec is the elements per thread, chosen
// by the caller (repro_torch/kernels/hier_aggregate.py: vector_width) so
// that P % vec == 0 and u and out are aligned to vec elements; splits and
// rows are ref.agg_splits(C, P): the blocks of a cluster and the rows each
// streams, every split non-empty. The launch<T, V> pairs below are exactly
// hier_aggregate.VEC_WIDTHS; tests/test_torch_hier_aggregate.py checks it.
extern "C" int hier_aggregate_launch(const void* u, const void* w, void* out,
                                     int C, long long P, int dtype, int vec,
                                     int splits, int rows, void* stream) {
  if (C <= 0 || P <= 0 || vec <= 0 || P % vec != 0 || splits < 1 ||
      splits > kMaxSplits || rows < 1 ||
      static_cast<long long>(splits - 1) * rows >= C ||
      static_cast<long long>(splits) * rows < C)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define AGG_ARGS u, w, out, C, P, splits, rows, s
  cudaError_t err;
  if (dtype == 0 && vec == 4) err = launch<float, 4>(AGG_ARGS);
  else if (dtype == 0 && vec == 2) err = launch<float, 2>(AGG_ARGS);
  else if (dtype == 0 && vec == 1) err = launch<float, 1>(AGG_ARGS);
  else if (dtype == 1 && vec == 8) err = launch<__nv_bfloat16, 8>(AGG_ARGS);
  else if (dtype == 1 && vec == 4) err = launch<__nv_bfloat16, 4>(AGG_ARGS);
  else if (dtype == 1 && vec == 2) err = launch<__nv_bfloat16, 2>(AGG_ARGS);
  else if (dtype == 1 && vec == 1) err = launch<__nv_bfloat16, 1>(AGG_ARGS);
  else err = cudaErrorInvalidValue;
#undef AGG_ARGS
  return static_cast<int>(err);
}

extern "C" const char* hier_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
