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
// What bounds it: the latency of each slot's dependent chain (a double
// cube root, IEEE divides, one masked reduction per fixed-point step, some
// 650 steps per group), not bytes: each input is read once and each output
// written once. On the scheduling path a group is a server's members plus
// one toggled device, so only a few percent of its R slots are active.
// Design:
//   - the threads of a group pack its active slots: the j-th active slot in
//     row order goes to thread j % L at step j / L (__ballot_sync and
//     __popc). Only active slots are loaded and computed; masked ones are
//     written as the constants the reference gives them (f = f_min,
//     beta = 0), and an empty group costs nothing;
//   - a group of at most 32 * kRegSteps active slots is solved by one warp
//     (L = 32), kWarps groups a block, so a launch of 1001 groups is one
//     wave of about 8 warps per SM, and every masked sum and maximum is one
//     xor-shuffle reduction;
//   - a wider group (up to kMaxR) is solved by a block of kWideThreads
//     threads (L = kWideThreads) of a second, persistent kernel, launched
//     only when R allows such a group: its reductions add a shared-memory
//     pass over the warp partials;
//   - a thread holding ST steps keeps them in registers and runs them whole
//     (one instantiation per ST of the dispatch table, picked per group
//     from its active count), with no branch between the steps' chains.
// Every reduction hands all threads the bitwise-same value, so all take the
// same branches. A thread adds its steps in turn, then each warp takes the
// halving tree of its 32 lanes, then (L > 32) the halving tree of the warp
// partials: ref.block_sum's order. The per-slot arithmetic is the
// reference's, op for op, and the cube root is taken in double as the plain
// version takes it; with -fmad=false the two agree bit for bit. The TPU
// version's block_g grid blocking (chosen for VMEM) is not carried over.
//
// Plain C entry point golden_section_launch: launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr float kGolden = 0.6180339887498949f;
constexpr unsigned kFull = 0xffffffffu;

// The dispatch table, read by repro_torch/kernels/ref.py too (GS_WARPS,
// GS_REG_STEPS, GS_WIDE_THREADS, MAX_R); tests/test_torch_golden_section.py
// checks that the two agree.
constexpr int kWarps = 4;           // groups (warps) per block, narrow path
constexpr int kRegSteps = 8;        // most steps a thread holds
constexpr int kWideThreads = 512;   // threads of a wide group's block
constexpr int kMaxR = 4096;         // widest group: kWideThreads * kRegSteps
constexpr int kWideWarps = kWideThreads / 32;

// NS sums then NM maxima (of values >= 0) over the warp, the shuffles of
// the values interleaved. Lane l adds lane l ^ o at o = 16, 8, ..., 1: the
// halving tree of the 32 lanes, and since a + b == b + a every lane ends
// with the same bits.
template <int NS, int NM>
__device__ __forceinline__ void warp_reduce(float (&v)[NS + NM]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < NS + NM; ++j) {
      const float other = __shfl_xor_sync(kFull, v[j], o);
      v[j] = j < NS ? v[j] + other : fmaxf(v[j], other);
    }
  }
}

// The same over L threads: each warp's tree, then every warp takes the tree
// of the L / 32 warp partials (its other lanes hold 0, the identity of both
// the sums and the maxima of values >= 0).
template <int L, int NS, int NM>
__device__ __forceinline__ void reduce(float (&v)[NS + NM],
                                       float (*sh)[kWideWarps]) {
  warp_reduce<NS, NM>(v);
  if constexpr (L > 32) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    __syncthreads();  // the previous reduction's reads of sh are done
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < NS + NM; ++j) sh[j][wid] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NS + NM; ++j)
      v[j] = lane < L / 32 ? sh[j][lane] : 0.f;
    warp_reduce<NS, NM>(v);
  }
}

__device__ __forceinline__ float cube_root(float v) {
#ifdef GS_CBRT_F32
  // cbrtf: faster, but not the plain version's rounding (built only to
  // measure that trade; see PERF.md)
  return cbrtf(v);
#else
  // in double, rounded to float, as the plain version does
  return static_cast<float>(cbrt(static_cast<double>(v)));
#endif
}

// One active slot: its constants, its row index, and its state (f; s holds
// beta's score, then beta).
struct Slot {
  float a, b, d, e, fmin, fmax, f, s;
  int r;
};

struct Inputs {
  const float *a, *b, *d, *e, *f_min, *f_max;
};

struct Outputs {
  float *f, *beta, *cost, *deadline;
};

// A thread's ST steps: packed slot j = L i + t at step i of thread t. The
// last step's threads past n hold inert slots and add nothing to the sums.
template <int ST, int L>
struct Steps {
  Slot x[ST];
  int n, t;

  // fn(slot, active) on every step, in step order
  template <class F>
  __device__ __forceinline__ void each(F&& fn) {
#pragma unroll
    for (int i = 0; i < ST; ++i) fn(x[i], L * i + t < n);
  }
};

template <int ST, int L>
struct Solver {
  Steps<ST, L> st;
  float w;
  float (*sh)[kWideWarps];  // L > 32: the reductions' warp partials

  // x.s = cube root score of x.f, eq. (19); returns max(sum, eps) over the
  // active slots
  __device__ __forceinline__ float score_total() {
    float v[1] = {0.f};
    st.each([&](Slot& x, bool act) {
      const float tau = 2.f * x.b * (x.f * x.f * x.f) / fmaxf(x.e, kEps);
      x.s = cube_root(fmaxf(x.a + tau * x.d, kEps));
      if (act) v[0] += x.s;
    });
    reduce<L, 1, 0>(v, sh);
    return fmaxf(v[0], kEps);
  }

  // the beta<->f fixed point at deadline t: leaves f and beta (in s)
  __device__ __forceinline__ void fb_of_t(float t, int n_inner) {
    st.each([&](Slot& x, bool) { x.f = sqrtf(x.fmin * x.fmax); });
    for (int it = 0; it < n_inner; ++it) {
      const float tot = score_total();
      st.each([&](Slot& x, bool) {
        x.s = x.s / tot;
        const float slack = t - x.d / fmaxf(x.s, kEps);
        const float fn = slack > 0.f ? x.e / fmaxf(slack, kEps) : x.fmax;
        x.f = fminf(fmaxf(fn, x.fmin), x.fmax);
      });
    }
    const float tot = score_total();
    st.each([&](Slot& x, bool) { x.s = x.s / tot; });
  }

  // objective (18) and the deadline max_n d/beta + e/f, at safe betas
  __device__ __forceinline__ float objective(float* deadline) {
    float v[2] = {0.f, 0.f};
    st.each([&](Slot& x, bool act) {
      const float sb = fmaxf(x.s, kEps);
      const float term = x.a / sb + x.b * (x.f * x.f);
      const float time = x.d / sb + x.e / x.f;
      if (act) {
        v[0] += term;
        v[1] = fmaxf(v[1], time);
      }
    });
    reduce<L, 1, 1>(v, sh);
    *deadline = v[1];
    return v[0] + w * v[1];
  }

  __device__ __forceinline__ float cost_of_t(float t, int n_inner) {
    float unused;
    fb_of_t(t, n_inner);
    return objective(&unused);
  }

  // the whole solve; returns the cost and sets the deadline
  __device__ __forceinline__ float solve(int n_golden, int n_inner,
                                         int n_bracket, float* deadline) {
    // ---- feasible deadline bracket, f_max and f_min bisections stacked ----
    // sum d, max(e/fmax + d), max(e/fmin + d)
    float init[3] = {0.f, 0.f, 0.f};
    st.each([&](Slot& x, bool act) {
      const float hi = x.e / x.fmax + x.d, lo = x.e / x.fmin + x.d;
      if (act) {
        init[0] += x.d;
        init[1] = fmaxf(init[1], hi);
        init[2] = fmaxf(init[2], lo);
      }
    });
    reduce<L, 1, 2>(init, sh);
    float lo0 = init[1], lo1 = init[2];
    float hi0 = lo0 + init[0] * 1e4f + 1.f;
    float hi1 = lo1 + init[0] * 1e4f + 1.f;
    for (int it = 0; it < n_bracket; ++it) {
      const float mid0 = 0.5f * (lo0 + hi0), mid1 = 0.5f * (lo1 + hi1);
      float s[2] = {0.f, 0.f};
      st.each([&](Slot& x, bool act) {
        const float sl0 = mid0 - x.e / x.fmax;
        const float sl1 = mid1 - x.e / x.fmin;
        const float q0 = sl0 <= 0.f ? 1e6f : x.d / fmaxf(sl0, kEps);
        const float q1 = sl1 <= 0.f ? 1e6f : x.d / fmaxf(sl1, kEps);
        if (act) {
          s[0] += q0;
          s[1] += q1;
        }
      });
      reduce<L, 2, 0>(s, sh);
      const bool ok0 = s[0] <= 1.f, ok1 = s[1] <= 1.f;
      lo0 = ok0 ? lo0 : mid0;
      hi0 = ok0 ? mid0 : hi0;
      lo1 = ok1 ? lo1 : mid1;
      hi1 = ok1 ? mid1 : hi1;
    }
    const float t_lo = hi0 * static_cast<float>(1.0 + 1e-6);
    const float t_hi = fmaxf(hi1 * 1.5f, t_lo * 4.f) + 1.f;

    // ---- golden section over t, single-eval recurrence (G^2 = 1 - G) ----
    // steps -2 and -1 price m1 and m2; one call site of cost_of_t keeps
    // the inlined code small
    float lo = t_lo, hi = t_hi;
    float m1 = hi - kGolden * (hi - lo);
    float m2 = lo + kGolden * (hi - lo);
    float c1 = 0.f, c2 = 0.f;
    for (int it = -2; it < n_golden; ++it) {
      bool go_right = false;
      float point = it == -2 ? m1 : m2;
      if (it >= 0) {
        go_right = c1 > c2;
        lo = go_right ? m1 : lo;
        hi = go_right ? hi : m2;
        const float m1n = hi - kGolden * (hi - lo);
        const float m2n = lo + kGolden * (hi - lo);
        point = go_right ? m2n : m1n;
      }
      const float cp = cost_of_t(point, n_inner);
      if (it == -2) {
        c1 = cp;
      } else if (it == -1) {
        c2 = cp;
      } else {
        const float m1_new = go_right ? m2 : point;
        const float c1_new = go_right ? c2 : cp;
        const float m2_new = go_right ? point : m1;
        const float c2_new = go_right ? cp : c1;
        m1 = m1_new; c1 = c1_new; m2 = m2_new; c2 = c2_new;
      }
    }
    fb_of_t(0.5f * (lo + hi), n_inner);

    // ---- finalize: clip, renormalize ----
    float part[1] = {0.f};
    st.each([&](Slot& x, bool act) {
      x.f = fminf(fmaxf(x.f, x.fmin), x.fmax);
      x.s = fmaxf(x.s, kEps);
      if (act) part[0] += x.s;
    });
    reduce<L, 1, 0>(part, sh);
    const float tot = fmaxf(part[0], kEps);
    st.each([&](Slot& x, bool) { x.s = x.s / tot; });
    return objective(deadline);
  }
};

// One group of n active slots (packed in idx) on L threads, ST steps each;
// t is this thread's index among the L.
template <int ST, int L>
__device__ __forceinline__ void solve_group(
    const Inputs& in, const unsigned short* idx, size_t row, int g, int n,
    int t, float w, float (*sh)[kWideWarps], const Outputs& out,
    int n_golden, int n_inner, int n_bracket) {
  Solver<ST, L> s;
  s.w = w;
  s.sh = sh;
  s.st.n = n;
  s.st.t = t;
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    const int j = L * i + t;
    s.st.x[i] = Slot{1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 0};  // inert
    if (j < n) {
      const size_t at = row + idx[j];
      s.st.x[i] = Slot{in.a[at], in.b[at], in.d[at], in.e[at], in.f_min[at],
                       in.f_max[at], 1.f, 1.f, idx[j]};
    }
  }
  float deadline;
  const float cost = s.solve(n_golden, n_inner, n_bracket, &deadline);
  s.st.each([&](Slot& x, bool act) {
    if (act) {
      out.f[row + x.r] = x.f;
      out.beta[row + x.r] = x.s;
    }
  });
  if (t == 0) {
    out.cost[g] = cost;
    out.deadline[g] = deadline;
  }
}

// Steps a thread -> the instantiation that holds them (ref.GS_REG_STEPS).
template <int L>
__device__ __forceinline__ void solve_packed(
    const Inputs& in, const unsigned short* idx, size_t row, int g, int n,
    int t, float w, float (*sh)[kWideWarps], const Outputs& out,
    int n_golden, int n_inner, int n_bracket) {
  const int steps = (n + L - 1) / L;
#define GS_SOLVE(ST)                                                \
  solve_group<ST, L>(in, idx, row, g, n, t, w, sh, out, n_golden, \
                     n_inner, n_bracket)
  if (steps <= 1) GS_SOLVE(1);
  else if (steps <= 2) GS_SOLVE(2);
  else if (steps <= 3) GS_SOLVE(3);
  else if (steps <= 4) GS_SOLVE(4);
  else if (steps <= 6) GS_SOLVE(6);
  else GS_SOLVE(8);
#undef GS_SOLVE
}

// The masked slots of a group: the reference's constants.
__device__ __forceinline__ void store_masked(const Inputs& in,
                                             const uint8_t* m, size_t row,
                                             int R, int t, int L,
                                             const Outputs& out) {
  for (int r = t; r < R; r += L) {
    if (m[r] == 0) {
      out.f[row + r] = in.f_min[row + r];
      out.beta[row + r] = 0.f;
    }
  }
}

// Narrow groups (n <= 32 * kRegSteps, empty ones included): one warp each.
// At least 3 blocks an SM: ptxas then keeps the widest instantiation in
// registers without spills, and 1584 groups fit in one wave.
__global__ void __launch_bounds__(kWarps * 32, 3)
golden_section_kernel(Inputs in, const float* __restrict__ w,
                      const uint8_t* __restrict__ mask, Outputs out, int G,
                      int R, int n_golden, int n_inner, int n_bracket) {
  __shared__ unsigned short packed[kWarps][32 * kRegSteps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarps + wid;
  if (g >= G) return;  // no block-wide barrier follows
  const size_t row = static_cast<size_t>(g) * R;
  const uint8_t* m = mask + row;

  int count = 0;
  for (int r = lane; r < R; r += 32) count += m[r] != 0;
  const int n = __reduce_add_sync(kFull, count);
  if (n > 32 * kRegSteps) return;  // golden_section_wide_kernel's

  if (n == 0) {
    if (lane == 0) {
      out.cost[g] = 0.f;
      out.deadline[g] = 0.f;
    }
  } else {
    unsigned short* idx = packed[wid];
    int base = 0;
    for (int c = 0; c < R; c += 32) {
      const int r = c + lane;
      const bool act = r < R && m[r] != 0;
      const unsigned bal = __ballot_sync(kFull, act);
      if (act) idx[base + __popc(bal & ((1u << lane) - 1u))] = r;
      base += __popc(bal);
    }
    __syncwarp();
    solve_packed<32>(in, idx, row, g, n, lane, w[g], nullptr, out,
                     n_golden, n_inner, n_bracket);
  }
  store_masked(in, m, row, R, lane, 32, out);
}

// Wide groups (n > 32 * kRegSteps): one block of kWideThreads each, the
// blocks walking the groups (a persistent grid of one block an SM).
__global__ void __launch_bounds__(kWideThreads, 1)
golden_section_wide_kernel(Inputs in, const float* __restrict__ w,
                           const uint8_t* __restrict__ mask, Outputs out,
                           int G, int R, int n_golden, int n_inner,
                           int n_bracket) {
  __shared__ unsigned short packed[kMaxR];
  __shared__ float sh[3][kWideWarps];
  __shared__ int warp_count[kWideWarps];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    const size_t row = static_cast<size_t>(g) * R;
    const uint8_t* m = mask + row;
    int count = 0;
    for (int r = t; r < R; r += kWideThreads) count += m[r] != 0;
    count = __reduce_add_sync(kFull, count);
    __syncthreads();  // the previous group is done with warp_count, packed
    if (lane == 0) warp_count[wid] = count;
    __syncthreads();
    int n = 0;
    for (int k = 0; k < kWideWarps; ++k) n += warp_count[k];
    if (n <= 32 * kRegSteps) continue;  // golden_section_kernel's

    // pack chunks of kWideThreads slots, each warp's active slots after
    // those of the chunk's earlier warps
    int base = 0;
    for (int c = 0; c < R; c += kWideThreads) {
      const int r = c + t;
      const bool act = r < R && m[r] != 0;
      const unsigned bal = __ballot_sync(kFull, act);
      __syncthreads();  // the last reads of warp_count are done
      if (lane == 0) warp_count[wid] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int k = 0; k < kWideWarps; ++k) {
        before += k < wid ? warp_count[k] : 0;
        total += warp_count[k];
      }
      if (act) packed[base + before + __popc(bal & ((1u << lane) - 1u))] = r;
      base += total;
    }
    __syncthreads();
    solve_packed<kWideThreads>(in, packed, row, g, n, t, w[g], sh, out,
                               n_golden, n_inner, n_bracket);
    store_masked(in, m, row, R, t, kWideThreads, out);
  }
}

}  // namespace

// Two launches when R allows a wide group (R > 32 * kRegSteps), one
// otherwise; each group is solved by exactly one of them.
extern "C" int golden_section_launch(
    const void* a, const void* b, const void* d, const void* e, const void* w,
    const void* f_min, const void* f_max, const void* mask, void* f_out,
    void* beta_out, void* cost_out, void* dl_out, int G, int R, int n_golden,
    int n_inner, int n_bracket, void* stream) {
  if (G <= 0 || R <= 0 || R > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<const float*>(d), static_cast<const float*>(e),
                  static_cast<const float*>(f_min),
                  static_cast<const float*>(f_max)};
  const Outputs out{static_cast<float*>(f_out), static_cast<float*>(beta_out),
                    static_cast<float*>(cost_out),
                    static_cast<float*>(dl_out)};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto wt = static_cast<const float*>(w);
  const auto mk = static_cast<const uint8_t*>(mask);
  golden_section_kernel<<<(G + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      in, wt, mk, out, G, R, n_golden, n_inner, n_bracket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || R <= 32 * kRegSteps) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  golden_section_wide_kernel<<<G < sms ? G : sms, kWideThreads, 0, s>>>(
      in, wt, mk, out, G, R, n_golden, n_inner, n_bracket);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* golden_section_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
