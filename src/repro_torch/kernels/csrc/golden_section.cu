// Batched golden-section KKT-path solve of problem (18) for Hopper (sm_90a).
//
// Replaces repro/kernels/golden_section.py::_golden_section_kernel (the
// Pallas TPU kernel behind golden_section_solve). Same function: for each of
// G candidate groups of R slots, the stacked f_max/f_min deadline-bracket
// bisection (n_bracket), the single-eval golden section over the deadline t
// (n_golden), at each probe n_inner beta<->f fixed-point steps with
// beta ~ cbrt(a + 2 b f^3 d / e), then the finalize clip/renormalize (cost 0
// for an empty group). The plain PyTorch version is
// repro_torch/kernels/ref.py::golden_section_ref.
//
// What bounds it: float32 ALU work (cube roots and IEEE divides, ~30 operations
// per slot per fixed-point step, ~650 steps per group), not bytes: each
// input is read once and each output written once. Every slot runs the
// whole fixed point, masked or not; a masked slot's result is discarded, so
// on sparse groups most of that work is not needed (skipping or compacting
// inactive slots is the first speed lever). Design: one thread block
// per group, the R slots spread over the block's threads, each thread
// holding its slots' constants and state in registers for the whole solve.
// Every loop stays on-chip; the only traffic between iterations is the
// masked sum/max reductions (warp shuffles plus a small shared array). A
// reduction hands every thread the bitwise-same value, so all threads take
// the same golden-section branches. The TPU version's block_g grid blocking
// (chosen for VMEM) is not carried over. The plain version sums in this
// kernel's order (ref.py: kernel_layout, block_sum) and takes the cube root
// in double as it does; with -fmad=false the two agree bit for bit.
//
// Plain C entry point golden_section_launch: launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr float kGolden = 0.6180339887498949f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction of NS sums followed by NM maxima (all values >= 0 for
// the maxima, so 0 is their identity). Every thread returns the full
// result; every warp reduces the same partials in the same order, so the
// result is bitwise identical across threads.
template <int NT, int NS, int NM>
__device__ __forceinline__ void block_reduce(float (&v)[NS + NM],
                                             float (*sh)[NT / 32]) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NS + NM; ++j)
    v[j] = j < NS ? warp_sum(v[j]) : warp_max(v[j]);
  __syncthreads();  // the previous reduction's reads of sh are done
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NS + NM; ++j) sh[j][wid] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NS + NM; ++j) {
    float p = lane < NW ? sh[j][lane] : 0.f;
    v[j] = j < NS ? warp_sum(p) : warp_max(p);
  }
}

template <int NT, int IT>
struct Group {
  float a[IT], b[IT], d[IT], e[IT], fmin[IT], fmax[IT];
  bool m[IT];
  float w;
  float (*sh)[NT / 32];

  // beta(f), eq. (19), normalized over the active slots
  __device__ __forceinline__ void beta_of_f(const float (&f)[IT],
                                            float (&beta)[IT]) {
    float part[1] = {0.f};
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      float tau = 2.f * b[i] * (f[i] * f[i] * f[i]) / fmaxf(e[i], kEps);
#ifdef GS_CBRT_F32
      // cbrtf: faster, but not the plain version's rounding (built only to
      // measure that trade; see PERF.md)
      float s = cbrtf(fmaxf(a[i] + tau * d[i], kEps));
#else
      // cube root in double, rounded to float, as the plain version does
      float s = static_cast<float>(
          cbrt(static_cast<double>(fmaxf(a[i] + tau * d[i], kEps))));
#endif
      beta[i] = m[i] ? s : 0.f;
      part[0] += beta[i];
    }
    block_reduce<NT, 1, 0>(part, sh);
    const float tot = fmaxf(part[0], kEps);
#pragma unroll
    for (int i = 0; i < IT; ++i) beta[i] = m[i] ? beta[i] / tot : 0.f;
  }

  __device__ __forceinline__ float safe(float beta, int i) const {
    return m[i] ? fmaxf(beta, kEps) : 1.f;
  }

  // the beta<->f fixed point at deadline t
  __device__ __forceinline__ void fb_of_t(float t, int n_inner,
                                          float (&f)[IT], float (&beta)[IT]) {
#pragma unroll
    for (int i = 0; i < IT; ++i) f[i] = sqrtf(fmin[i] * fmax[i]);
    for (int it = 0; it < n_inner; ++it) {
      beta_of_f(f, beta);
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        float slack = t - d[i] / safe(beta[i], i);
        float fn = slack > 0.f ? e[i] / fmaxf(slack, kEps) : fmax[i];
        f[i] = fminf(fmaxf(fn, fmin[i]), fmax[i]);
      }
    }
    beta_of_f(f, beta);
  }

  // objective (18) and the deadline max_n d/beta + e/f, at safe betas
  __device__ __forceinline__ float objective(const float (&f)[IT],
                                             const float (&beta)[IT],
                                             float* deadline) {
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (m[i]) {
        float sb = safe(beta[i], i);
        v[0] += a[i] / sb + b[i] * (f[i] * f[i]);
        v[1] = fmaxf(v[1], d[i] / sb + e[i] / f[i]);
      }
    }
    block_reduce<NT, 1, 1>(v, sh);
    if (deadline) *deadline = v[1];
    return v[0] + w * v[1];
  }

  __device__ __forceinline__ float cost_of_t(float t, int n_inner) {
    float f[IT], beta[IT];
    fb_of_t(t, n_inner, f, beta);
    return objective(f, beta, nullptr);
  }
};

template <int NT, int IT>
__global__ void __launch_bounds__(NT)
golden_section_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ d, const float* __restrict__ e,
                      const float* __restrict__ w,
                      const float* __restrict__ f_min,
                      const float* __restrict__ f_max,
                      const uint8_t* __restrict__ mask, float* __restrict__ f_out,
                      float* __restrict__ beta_out,
                      float* __restrict__ cost_out, float* __restrict__ dl_out,
                      int R, int n_golden, int n_inner, int n_bracket) {
  __shared__ float sh[4][NT / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * R;
  Group<NT, IT> g;
  g.sh = sh;
  g.w = w[blockIdx.x];
  // slots past R are inert: unit constants, mask false, never written
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int r = threadIdx.x + i * NT;
    const bool in = r < R;
    g.a[i] = in ? a[base + r] : 1.f;
    g.b[i] = in ? b[base + r] : 1.f;
    g.d[i] = in ? d[base + r] : 1.f;
    g.e[i] = in ? e[base + r] : 1.f;
    g.fmin[i] = in ? f_min[base + r] : 1.f;
    g.fmax[i] = in ? f_max[base + r] : 1.f;
    g.m[i] = in && mask[base + r] != 0;
  }

  // ---- feasible deadline bracket, f_max and f_min bisections stacked ----
  // sum d, active count, max(e/fmax + d), max(e/fmin + d)
  float init[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    if (g.m[i]) {
      init[0] += g.d[i];
      init[1] += 1.f;
      init[2] = fmaxf(init[2], g.e[i] / g.fmax[i] + g.d[i]);
      init[3] = fmaxf(init[3], g.e[i] / g.fmin[i] + g.d[i]);
    }
  }
  block_reduce<NT, 2, 2>(init, sh);
  const float n_act = init[1];
  float lo0 = init[2], lo1 = init[3];
  float hi0 = lo0 + init[0] * 1e4f + 1.f;
  float hi1 = lo1 + init[0] * 1e4f + 1.f;
  for (int it = 0; it < n_bracket; ++it) {
    const float mid0 = 0.5f * (lo0 + hi0), mid1 = 0.5f * (lo1 + hi1);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (g.m[i]) {
        const float sl0 = mid0 - g.e[i] / g.fmax[i];
        const float sl1 = mid1 - g.e[i] / g.fmin[i];
        s[0] += sl0 <= 0.f ? 1e6f : g.d[i] / fmaxf(sl0, kEps);
        s[1] += sl1 <= 0.f ? 1e6f : g.d[i] / fmaxf(sl1, kEps);
      }
    }
    block_reduce<NT, 2, 0>(s, sh);
    const bool ok0 = s[0] <= 1.f, ok1 = s[1] <= 1.f;
    lo0 = ok0 ? lo0 : mid0;
    hi0 = ok0 ? mid0 : hi0;
    lo1 = ok1 ? lo1 : mid1;
    hi1 = ok1 ? mid1 : hi1;
  }
  const float t_lo = hi0 * static_cast<float>(1.0 + 1e-6);
  const float t_hi = fmaxf(hi1 * 1.5f, t_lo * 4.f) + 1.f;

  // ---- golden section over t, single-eval recurrence (G^2 = 1 - G) ----
  float lo = t_lo, hi = t_hi;
  float m1 = hi - kGolden * (hi - lo);
  float m2 = lo + kGolden * (hi - lo);
  float c1 = g.cost_of_t(m1, n_inner);
  float c2 = g.cost_of_t(m2, n_inner);
  for (int it = 0; it < n_golden; ++it) {
    const bool go_right = c1 > c2;
    lo = go_right ? m1 : lo;
    hi = go_right ? hi : m2;
    const float m1n = hi - kGolden * (hi - lo);
    const float m2n = lo + kGolden * (hi - lo);
    const float point = go_right ? m2n : m1n;
    const float cp = g.cost_of_t(point, n_inner);
    const float m1_new = go_right ? m2 : point;
    const float c1_new = go_right ? c2 : cp;
    const float m2_new = go_right ? point : m1;
    const float c2_new = go_right ? cp : c1;
    m1 = m1_new; c1 = c1_new; m2 = m2_new; c2 = c2_new;
  }
  float f[IT], beta[IT];
  g.fb_of_t(0.5f * (lo + hi), n_inner, f, beta);

  // ---- finalize: clip, renormalize, cost 0 for an empty group ----
  float part[1] = {0.f};
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    f[i] = g.m[i] ? fminf(fmaxf(f[i], g.fmin[i]), g.fmax[i]) : g.fmin[i];
    beta[i] = g.m[i] ? fmaxf(beta[i], kEps) : 0.f;
    part[0] += beta[i];
  }
  block_reduce<NT, 1, 0>(part, sh);
  const float tot = fmaxf(part[0], kEps);
#pragma unroll
  for (int i = 0; i < IT; ++i) beta[i] = g.m[i] ? beta[i] / tot : 0.f;
  float deadline;
  const float cost = g.objective(f, beta, &deadline);

#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int r = threadIdx.x + i * NT;
    if (r < R) {
      f_out[base + r] = f[i];
      beta_out[base + r] = beta[i];
    }
  }
  if (threadIdx.x == 0) {
    cost_out[blockIdx.x] = n_act > 0.f ? cost : 0.f;
    dl_out[blockIdx.x] = deadline;
  }
}

template <int NT, int IT>
cudaError_t launch(const float* a, const float* b, const float* d,
                   const float* e, const float* w, const float* f_min,
                   const float* f_max, const uint8_t* mask, float* f_out,
                   float* beta_out, float* cost_out, float* dl_out, int G,
                   int R, int n_golden, int n_inner, int n_bracket,
                   cudaStream_t stream) {
  golden_section_kernel<NT, IT><<<G, NT, 0, stream>>>(
      a, b, d, e, w, f_min, f_max, mask, f_out, beta_out, cost_out, dl_out, R,
      n_golden, n_inner, n_bracket);
  return cudaGetLastError();
}

}  // namespace

// nt threads per block, it slots per thread: the layout is chosen by the
// caller (repro_torch/kernels/ref.py: kernel_layout), which the plain
// version's reduction order follows too. The launch<NT, IT> pairs below are
// exactly ref.KERNEL_LAYOUTS; tests/test_torch_golden_section.py checks it.
extern "C" int golden_section_launch(
    const void* a, const void* b, const void* d, const void* e, const void* w,
    const void* f_min, const void* f_max, const void* mask, void* f_out,
    void* beta_out, void* cost_out, void* dl_out, int G, int R, int nt,
    int it, int n_golden, int n_inner, int n_bracket, void* stream) {
  if (G <= 0 || R <= 0 || R > nt * it)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define GS_ARGS                                                             \
  static_cast<const float*>(a), static_cast<const float*>(b),               \
      static_cast<const float*>(d), static_cast<const float*>(e),           \
      static_cast<const float*>(w), static_cast<const float*>(f_min),       \
      static_cast<const float*>(f_max), static_cast<const uint8_t*>(mask),  \
      static_cast<float*>(f_out), static_cast<float*>(beta_out),            \
      static_cast<float*>(cost_out), static_cast<float*>(dl_out), G, R,     \
      n_golden, n_inner, n_bracket, s
  cudaError_t err;
  if (nt == 64 && it == 1) err = launch<64, 1>(GS_ARGS);
  else if (nt == 256 && it == 1) err = launch<256, 1>(GS_ARGS);
  else if (nt == 256 && it == 2) err = launch<256, 2>(GS_ARGS);
  else if (nt == 256 && it == 4) err = launch<256, 4>(GS_ARGS);
  else if (nt == 512 && it == 4) err = launch<512, 4>(GS_ARGS);
  else if (nt == 512 && it == 8) err = launch<512, 8>(GS_ARGS);
  else err = cudaErrorInvalidValue;
#undef GS_ARGS
  return static_cast<int>(err);
}

extern "C" const char* golden_section_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
