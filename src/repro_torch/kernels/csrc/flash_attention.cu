// Flash attention forward (online softmax) on (B, S, H, hd), for Hopper
// (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel behind flash_attention_fwd). Same function: for q (B, Sq, Hq, hd)
// and k, v (B, Skv, Hkv, hd), q head h reads kv head h / (Hq / Hkv) (GQA, no
// repeat), scores scaled by the wrapper's scale (hd^-0.5), causal mask
// kv_pos <= q_pos aligned top-left as the Pallas kernel aligns it (the same
// as the reference's bottom-right mask when Sq == Skv), float32 softmax
// statistics and float32 accumulation, output divided by max(l, 1e-30)
// and rounded to q's type. The plain PyTorch version is
// repro_torch/kernels/ref.py::flash_attention_ref.
//
// What bounds it: operations. Causal attention at qwen3-0.6b's prefill
// shape (B=4, S=4096, 16 heads of 128) is 2.75e11 multiply-adds counted as
// 2 operations (QK^T and PV over the visible half), 0.28 ms at the bf16
// dense tensor-core peak, against 0.05 ms for its bytes. Design: one block
// of four warps per 64 query rows of one (batch, head); it walks the kv
// tiles of 64 rows from the first to the last one its rows can see
// (causal tiles above the diagonal are never loaded), with q, k and v
// tiles in shared memory. The ragged edge (Sq or Skv not a multiple of 64)
// is masked here; the Pallas block_q / block_kv do not reach the kernel,
// whose tile is its own choice.
//   bfloat16: each warp owns 16 query rows; S = Q K^T and O += P V run on
//   the tensor cores (wmma 16x16x16, bf16 in, f32 accumulate); S goes
//   through shared memory to the softmax, where lanes 2r and 2r + 1 share
//   row r, and P is rounded to bf16 for the PV product (the one rounding
//   the plain version does not make). O stays in accumulator fragments and
//   is rescaled through a fragment of the per-row correction factors,
//   which has the same element layout.
//   float32: the same walk on the CUDA cores, thread pair per row, so no
//   TF32 rounding enters.
// Faster designs (wgmma, TMA, a producer warp, larger tiles) are later
// work.
//
// Plain C entry point flash_attention_launch: launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;    // query rows per block
constexpr int kBKV = 64;   // kv rows per tile
constexpr int kWarps = 4;  // 16 query rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kBKV / 2;  // score columns per thread
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Hq, Hkv;
  float scale;
  int causal;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// kv tiles the block starting at query row q0 has to visit
__device__ __forceinline__ int visible_tiles(const Args& a, int q0) {
  const int all = cdiv(a.Skv, kBKV);
  if (!a.causal) return all;
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  return min(all, q_last / kBKV + 1);
}

// rows [s0, s0 + 64) of head h of batch b of a (B, S, H, HD) tensor into
// shared memory with row stride LD elements, zeros past row S - 1.
// 16-byte loads; HD * sizeof(T) is a multiple of 16.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int b, int s0,
                                          int S, int H, int h) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kBKV * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<long long>(b) * S + s) * H + h) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// One tile's online-softmax update of the row that lanes 2r and 2r + 1
// share. x[j] holds the log2-scaled score of column 2j + (lane & 1), or
// kNegInf where masked; on return it holds p. Updates the row's running
// max m and sum l (the same in both lanes) and returns the factor the
// row's accumulator is rescaled by.
__device__ __forceinline__ float softmax_step(float (&x)[kCols], float& m,
                                              float& l) {
  float tmax = kNegInf;
#pragma unroll
  for (int j = 0; j < kCols; ++j) tmax = fmaxf(tmax, x[j]);
  tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
  const float m_new = fmaxf(m, tmax);
  const float corr = exp2f(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    x[j] = x[j] == kNegInf ? 0.f : exp2f(x[j] - m_new);
    sum = sum + x[j];
  }
  sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
  l = l * corr + sum;
  m = m_new;
  return corr;
}

// ---------------------------------------------------------------- bf16 --

template <int HD>
struct Bf16Smem {
  static constexpr int kLdQK = HD + 8;     // bf16 elements (16-byte pad)
  static constexpr int kLdS = kBKV + 4;    // f32
  static constexpr int kLdP = kBKV + 8;    // bf16
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLdQK * 2;
  static constexpr int kV = kK + kBKV * kLdQK * 2;
  static constexpr int kS = kV + kBKV * kLdQK * 2;
  static constexpr int kP = kS + kBQ * kLdS * 4;
  static constexpr int kC = kP + kBQ * kLdP * 2;
  static constexpr int kBytes = kC + kWarps * 16 * 16 * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(Args a) {
  using L = Bf16Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  auto* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  auto* Ss = reinterpret_cast<float*>(smem + L::kS);
  auto* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  auto* Cs = reinterpret_cast<float*>(smem + L::kC);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rr = lane >> 1, half = lane & 1;
  const int row = warp * 16 + rr;  // this lane pair's query row in the tile
  const int q_pos = q0 + row;
  const float qk_scale = a.scale * kLog2e;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* k = static_cast<const __nv_bfloat16*>(a.k);
  const auto* v = static_cast<const __nv_bfloat16*>(a.v);
  float* Cw = Cs + warp * 256;

  load_tile<__nv_bfloat16, HD, L::kLdQK>(Qs, q, b, q0, a.Sq, a.Hq, h);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  float m = kNegInf, l = 0.f;

  const int n_tiles = visible_tiles(a, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile<__nv_bfloat16, HD, L::kLdQK>(Ks, k, b, kv0, a.Skv, a.Hkv, hk);
    load_tile<__nv_bfloat16, HD, L::kLdQK>(Vs, v, b, kv0, a.Skv, a.Hkv, hk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < kBKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + warp * 16 * L::kLdQK + kk * 16,
                               L::kLdQK);
        wmma::load_matrix_sync(fb, Ks + n * 16 * L::kLdQK + kk * 16,
                               L::kLdQK);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::kLdS + n * 16, s, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    float x[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = 2 * j + half, kv_pos = kv0 + c;
      const bool ok = kv_pos < a.Skv && (!a.causal || kv_pos <= q_pos);
      x[j] = ok ? Ss[row * L::kLdS + c] * qk_scale : kNegInf;
    }
    const float corr = softmax_step(x, m, l);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      Ps[row * L::kLdP + 2 * j + half] = __float2bfloat16_rn(x[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) Cw[rr * 16 + half * 8 + j] = corr;
    __syncwarp();

    // O = O * corr + P V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    wmma::load_matrix_sync(cf, Cw, 16, wmma::mem_row_major);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
      for (int i = 0; i < cf.num_elements; ++i) o[n].x[i] = o[n].x[i] * cf.x[i];
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + warp * 16 * L::kLdP + kk * 16,
                               L::kLdP);
        wmma::load_matrix_sync(fv, Vs + kk * 16 * L::kLdQK + n * 16,
                               L::kLdQK);
        wmma::mma_sync(o[n], fp, fv, o[n]);
      }
    }
  }

  // out = O / max(l, 1e-30), 16 columns at a time through this warp's
  // staging tile; lanes 2r, 2r + 1 write row r's two 8-column halves
  const float denom = fmaxf(l, 1e-30f);
  auto* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    __syncwarp();
    wmma::store_matrix_sync(Cw, o[n], 16, wmma::mem_row_major);
    __syncwarp();
    if (q_pos < a.Sq) {
      __align__(16) __nv_bfloat16 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = __float2bfloat16_rn(Cw[rr * 16 + half * 8 + j] / denom);
      *reinterpret_cast<uint4*>(
          out + ((static_cast<long long>(b) * a.Sq + q_pos) * a.Hq + h) * HD +
          n * 16 + half * 8) = *reinterpret_cast<const uint4*>(y);
    }
  }
}

// ----------------------------------------------------------------- f32 --

template <int HD>
struct F32Smem {
  static constexpr int kLd = HD + 4;      // f32 elements (16-byte pad)
  static constexpr int kLdP = kBKV + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd * 4;
  static constexpr int kV = kK + kBKV * kLd * 4;
  static constexpr int kP = kV + kBKV * kLd * 4;
  static constexpr int kBytes = kP + kBQ * kLdP * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(Args a) {
  using L = F32Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Qs = reinterpret_cast<float*>(smem + L::kQ);
  auto* Ks = reinterpret_cast<float*>(smem + L::kK);
  auto* Vs = reinterpret_cast<float*>(smem + L::kV);
  auto* Ps = reinterpret_cast<float*>(smem + L::kP);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int q_pos = q0 + row;
  const float qk_scale = a.scale * kLog2e;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);

  load_tile<float, HD, L::kLd>(Qs, q, b, q0, a.Sq, a.Hq, h);

  float o[HD / 2];  // columns 2j + half of this row
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = visible_tiles(a, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();
    load_tile<float, HD, L::kLd>(Ks, k, b, kv0, a.Skv, a.Hkv, hk);
    load_tile<float, HD, L::kLd>(Vs, v, b, kv0, a.Skv, a.Hkv, hk);
    __syncthreads();

    float x[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[row * L::kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        x[j] = x[j] + qd * Ks[(2 * j + half) * L::kLd + d];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kv_pos = kv0 + 2 * j + half;
      const bool ok = kv_pos < a.Skv && (!a.causal || kv_pos <= q_pos);
      x[j] = ok ? x[j] * qk_scale : kNegInf;
    }
    const float corr = softmax_step(x, m, l);
#pragma unroll
    for (int j = 0; j < kCols; ++j) Ps[row * L::kLdP + 2 * j + half] = x[j];
    __syncwarp();  // a warp's 16 rows are written by that warp only
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = o[j] * corr;
    for (int c = 0; c < kBKV; ++c) {
      const float p = Ps[row * L::kLdP + c];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j)
        o[j] = o[j] + p * Vs[c * L::kLd + 2 * j + half];
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

  if (q_pos < a.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* out = static_cast<float*>(a.o) +
                 ((static_cast<long long>(b) * a.Sq + q_pos) * a.Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) out[2 * j + half] = o[j] / denom;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem_bytes, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Sq, kBQ), a.Hq, a.B);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_fwd_f32<HD>, F32Smem<HD>::kBytes, a, stream);
  if (dtype == 1)
    return launch(flash_fwd_bf16<HD>, Bf16Smem<HD>::kBytes, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16. q (B, Sq, Hq, hd), k and v
// (B, Skv, Hkv, hd), o like q, all contiguous and 16-byte aligned;
// Hq % Hkv == 0. The head dims below are exactly
// flash_attention.HEAD_DIMS; a CPU test checks it. Each is a multiple of
// 16 (whole wmma tiles, 16-byte row loads); 80 is zamba2's shared block.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int hd,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd == 16) err = launch_hd<16>(a, dtype, s);
  else if (hd == 32) err = launch_hd<32>(a, dtype, s);
  else if (hd == 64) err = launch_hd<64>(a, dtype, s);
  else if (hd == 80) err = launch_hd<80>(a, dtype, s);
  else if (hd == 128) err = launch_hd<128>(a, dtype, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
