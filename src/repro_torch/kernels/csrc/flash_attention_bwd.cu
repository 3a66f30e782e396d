// Flash attention backward on (B, S, H, hd), for Hopper (sm_90a).
//
// Replaces repro/kernels/ops.py::_fa_bwd (lines 38-43), the backward of the
// JAX package's flash attention: it has no Pallas kernel of its own, but
// takes jax.vjp through ref.flash_attention_ref (XLA autodiff of the
// reference). Same function: for q (B, Sq, Hq, hd), k and v (B, Skv, Hkv,
// hd) (q head h reads kv head h / (Hq / Hkv)), the forward's output o and
// the output's cotangent dO (both like q), scores scaled by c (the
// wrapper's scale), the top-left causal mask kv_pos <= q_pos or none, Sq
// and Skv free:
//   P = 2^(c log2(e) q k^T - lse)   (lse: the forward's logsumexp of each
//                                     row, log2 units, flash_attention.cu)
//   D = rowsum(dO o),  dS = P (dO v^T - D),
//   dq = c dS k,  dk = c dS^T q,  dv = P^T dO,
// float32 throughout, results rounded to the inputs' type. The plain
// PyTorch version is repro_torch/kernels/ref.py::flash_attention_bwd_ref.
//
// What bounds it: operations. Five products over the visible (q, kv) pairs
// (S, dP, dV, dK, dQ), 2 hd operations each a pair: at qwen3-0.6b's train
// layer (B=4, S=4096, 16/8 heads of 128, causal) 6.9e11, 0.695 ms at the
// bf16 dense tensor-core peak, against 0.06 ms for the bytes.
//
// Design: three launches (four above hd 128), with no atomics, so dq, dk
// and dv are the same bits from run to run (every sum runs in a fixed
// order).
//   flash_bwd_pre: D = rowsum(dO o) in float32, 8 threads a row, into a
//     (B, Hq, Sq_pad) scratch beside a copy of lse (Sq_pad: Sq rounded up
//     to kPad); past Sq, D = 0 and lse = +inf, so a padded row has P = 0.
//   flash_bwd_dkdv: a block owns 128 kv rows of one (batch, kv head) and
//     walks, for every q head of its GQA group, the 64-row q tiles that can
//     see them: dK and dV add up in registers over the whole walk, with no
//     atomics and no second pass. Each consumer warpgroup owns 64 kv rows
//     and computes the transposed products, kv rows as wgmma's M:
//       S^T = K Q^T and dP^T = V dO^T (m64n64k16; K, V, Q and dO K-major in
//       shared memory, the forward's S = Q K^T), P^T and dS^T elementwise in
//       registers, then dV += P^T dO and dK += dS^T Q (P^T and dS^T packed
//       to bf16 as the A operand from registers, dO and Q MN-major from
//       shared memory: the forward's P V with dO or Q in V's place).
//     Above hd 128, dK and dV (hd / 2 float32 registers each) do not fit
//     beside S^T and dP^T, so two launches walk the same tiles, one for dV
//     (products S, dV) and one for dK (S, dP, dK).
//   flash_bwd_dq: a block owns 128 q rows of one (batch, q head) and walks
//     the 64-row kv tiles they see, as the forward does: S = Q K^T and
//     dP = dO V^T, dS in registers, dQ += dS K (dS the A operand from
//     registers, K MN-major). It recomputes S and dP, seven products in all
//     where five would do, so that dQ needs neither float32 atomics into a
//     scratch (whose order changes from run to run) nor a conversion pass.
//   Both bf16 kernels have the forward's shape: warpgroup 0 produces (one
//   thread starts every copy; setmaxnreg.dec 24), warpgroups 1 and 2
//   consume (setmaxnreg.inc 240); a ring of 3 stages (2 above hd 128) with
//   a full and an empty mbarrier each; the forward's column parts
//   (Parts<HD>: 64-column boxes with a 128-byte swizzle, tails of 32 and 16
//   columns at hd 80 and 112) and its tensor maps. The dK/dV ring holds Q,
//   dO and their rows' lse and D (1-D bulk copies), the dQ ring K and V.
//   P and dS never touch shared memory. Both grids put the tile index
//   slowest (blockIdx.z), so under the causal mask the longest walks (the
//   first kv tiles, the last q tiles) start first and no long block is
//   left for the end. Live registers of a consumer thread, about: dK/dV
//   kernel hd (dK and dV) + 64 (S^T and dP^T, packed into 32 as they
//   die), 208 at hd 128; dQ kernel hd / 2 + 64 + 16. ptxas gives every
//   bf16 instantiation 168 at the launch bound and the consumers'
//   setmaxnreg 240, with no spills (chip_smoke.py prints its report and
//   asserts it). Of the float32 ones, the dV launch at hd 192 spills 4
//   bytes (an 8-byte stack frame); the others do not. The roundings
//   against the plain version: P and dS to bf16 as the A operands, and
//   the results to bf16.
//
// float32 (the card-vs-CPU checks): the same three steps on the CUDA cores,
// a thread pair per row, 64-row tiles in shared memory (the forward's
// float32 scheme), so no TF32 rounding enters.
//
// Plain C entry point flash_attention_bwd_launch: launches on the given
// stream, does not synchronise, allocates nothing, returns
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 128;   // Sq_pad, the scratch's rows, is a multiple

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, Hq, Sq), log2 units
  float* lse_p;       // (B, Hq, Sq_pad) scratch: lse, +inf past Sq
  float* dsum;        // (B, Hq, Sq_pad) scratch: D, 0 past Sq
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv, Sq_pad;
  float scale;
  int causal;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// dS from P, dP and the row's D (every kernel and type)
__device__ __forceinline__ float dscore(float p, float dp, float d) {
  return p * (dp - d);
}

// ------------------------------------------------------------- pre-pass --

constexpr int kPreRows = 32;   // rows a block, 8 threads a row

__device__ __forceinline__ float dot_chunk(uint4 x, uint4 y, const float*) {
  return __uint_as_float(x.x) * __uint_as_float(y.x) +
         __uint_as_float(x.y) * __uint_as_float(y.y) +
         __uint_as_float(x.z) * __uint_as_float(y.z) +
         __uint_as_float(x.w) * __uint_as_float(y.w);
}

__device__ __forceinline__ float dot_chunk(uint4 x, uint4 y,
                                           const __nv_bfloat16*) {
  const auto* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const auto* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(xa[e]), w = __bfloat1622float2(ya[e]);
    s += u.x * w.x + u.y * w.y;
  }
  return s;
}

// row r of the (B, Hq, Sq_pad) scratch: D and lse of q row r % Sq_pad of
// (batch, head) r / Sq_pad
template <typename T, int HD>
__global__ void __launch_bounds__(8 * kPreRows)
    flash_bwd_pre(Args a) {
  const int row = blockIdx.x * kPreRows + (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  const int qi = row % a.Sq_pad, bh = row / a.Sq_pad;
  const int h = bh % a.Hq, b = bh / a.Hq;
  constexpr int kVec = 16 / sizeof(T);   // elements in 16 bytes
  float d = 0.f, lse2 = pos_inf();
  if (qi < a.Sq) {
    const long long off =
        ((static_cast<long long>(b) * a.Sq + qi) * a.Hq + h) * HD;
    const T* o = static_cast<const T*>(a.o) + off;
    const T* g = static_cast<const T*>(a.dout) + off;
    for (int c = sub; c < HD / kVec; c += 8)
      d += dot_chunk(*reinterpret_cast<const uint4*>(o + c * kVec),
                     *reinterpret_cast<const uint4*>(g + c * kVec), o);
    lse2 = a.lse[static_cast<long long>(bh) * a.Sq + qi];   // log2 units
  }
  d += __shfl_xor_sync(0xffffffffu, d, 4);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (sub == 0) {
    a.dsum[row] = d;
    a.lse_p[row] = lse2;
  }
}

// The dK/dV walk of the kv rows from kv0: for each q head of the group,
// the q tiles of kBQ rows from dkdv_first on (the causal mask hides the
// earlier ones: q_pos < kv0); step i is head i / per_head, tile
// first + i % per_head
constexpr int kBQ = 64;     // q rows a step of the dK/dV walk

__device__ __forceinline__ int dkdv_first(const Args& a, int kv0) {
  const int n = cdiv(a.Sq, kBQ);
  return a.causal ? min(kv0 / kBQ, n) : 0;
}

__device__ __forceinline__ int dkdv_steps(const Args& a, int kv0) {
  const int per_head = cdiv(a.Sq, kBQ) - dkdv_first(a, kv0);
  return (a.Hq / a.Hkv) * per_head;   // every q head of the GQA group
}

// kv tiles of BKV rows that q rows [q0, q0 + BQ) see
template <int BQ, int BKV>
__device__ __forceinline__ int visible_tiles(const Args& a, int q0) {
  const int all = cdiv(a.Skv, BKV);
  if (!a.causal) return all;
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  return min(all, q_last / BKV + 1);
}

// ---------------------------------------------------------------- bf16 --

constexpr int kBKV = 128;      // dK/dV: kv rows a block, 64 a consumer
constexpr int kQRows = 128;    // dQ: q rows a block, 64 a consumer
constexpr int kKVRows = 64;    // dQ: kv rows a step
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 produces
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// ring stages: 3, but 2 above hd 128, where three would pass the 227 KB a
// block may have (dK/dV at hd 192: K and V 96 KB, a stage 48 KB)
template <int HD>
__host__ __device__ constexpr int stages() {
  return HD > 128 ? 2 : 3;
}

// The head dim in the column parts a TMA box and a wgmma swizzle atom
// hold: kN0 leading parts of kW0 = min(HD, 64) columns, whose rows are
// 2 kW0 bytes (a 128-byte swizzle at 64 columns, 64 at 32, 32 at 16), then
// the tail, the rest of the columns, as a part of 32 (64-byte swizzle)
// and one of 16 (32-byte swizzle) where they are needed: 16 at HD = 80,
// 32 + 16 at HD = 112. A tile of R rows keeps part p at byte
// R * 2 * col(p), rows of 2 * width(p) bytes. Part p's tensor map is
// map(p): 0 for the leading parts, then one per tail part.
template <int HD>
struct Parts {
  static constexpr int kW0 = HD < 64 ? HD : 64;
  static constexpr int kN0 = HD / kW0;
  static constexpr int kTail = HD - kN0 * kW0;
  static constexpr int kT32 = kTail & 32, kT16 = kTail & 16;
  static constexpr int kCount = kN0 + (kT32 ? 1 : 0) + (kT16 ? 1 : 0);
  static_assert(kTail == kT32 + kT16, "head dim not covered");
  __host__ __device__ static constexpr int width(int p) {
    return p < kN0 ? kW0 : (p == kN0 && kT32) ? 32 : 16;
  }
  __host__ __device__ static constexpr int col(int p) {
    return p <= kN0 ? p * kW0 : kN0 * kW0 + kT32;
  }
  __host__ __device__ static constexpr int map(int p) {
    return p < kN0 ? 0 : 1 + p - kN0;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of parity `parity` to complete (no timeout, as in the
// forward: a trap on this path costs the consumers their registers)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a box of the (hd, H, S, B) view into shared memory at dst, completing on
// bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(s), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (16-byte units) and the swizzle of rows of `row_bytes` (128, 64 or 32)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving uses of wgmma registers across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (+)= A B^T for one m64n64k16 step, A and B K-major in shared memory
// (descriptors); scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B for one m64n16k16 step, A (four bf16x2 registers) from
// registers, B MN-major in shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B for one m64n32k16 step, A (four bf16x2 registers) from
// registers, B MN-major in shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B for one m64n64k16 step, A (four bf16x2 registers) from
// registers, B MN-major in shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B for one m64n128k16 step, A (four bf16x2 registers) from
// registers, B MN-major in shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B for one m64n192k16 step, A (four bf16x2 registers) from
// registers, B MN-major in shared memory (descriptor)
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

// 2^x, flushing results below 2^-126 to zero (a probability that small
// adds nothing at float32 precision)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a box of 1-D bytes (16-byte aligned, a multiple of 16) into shared
// memory at dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// D (64 x N) = A B^T over the head dim, part by part: A the 64 rows from
// row a0 of a tile of RA rows at a_s, B a tile of N rows at b_s, both
// K-major (the forward's S = Q K^T); a k16 step inside a swizzled row
// advances the start address by 32 bytes
template <int HD, int RA, int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a_s,
                                           int a0, uint32_t b_s) {
  static_assert(N == 64, "S is m64n64");
  using P = Parts<HD>;
#pragma unroll
  for (int p = 0; p < P::kCount; ++p) {
    const int rb = 2 * P::width(p);
    const uint32_t a_p = a_s + RA * 2 * P::col(p) + a0 * rb;
    const uint32_t b_p = b_s + N * 2 * P::col(p);
#pragma unroll
    for (int st = 0; st < P::width(p) / 16; ++st)
      wgmma_ss_n64(d, make_desc(a_p + 32 * st, 16, 8 * rb, rb),
                   make_desc(b_p + 32 * st, 16, 8 * rb, rb), p + st);
  }
}

// D (64 x HD) += A B for A's k16 step kk (fa, from registers) and rows
// [16 kk, 16 kk + 16) of B, a tile of R rows at b_s read MN-major (the
// forward's O += P V): the leading parts as one wgmma of kN0 * kW0
// columns, the part stride as its leading byte offset; each tail part as
// one of its width
template <int HD, int R>
__device__ __forceinline__ void rs_step(float (&d)[HD / 2],
                                        const uint32_t (&fa)[4],
                                        uint32_t b_s, int kk) {
  using P = Parts<HD>;
  constexpr int rb = 2 * P::kW0;
  wgmma_rs<P::kN0 * P::kW0>(
      d, fa, make_desc(b_s + 16 * kk * rb, R * rb, 8 * rb, rb));
  auto tail = [&](int p) {
    const int tb = 2 * P::width(p);
    return make_desc(b_s + R * 2 * P::col(p) + 16 * kk * tb, 16, 8 * tb,
                     tb);
  };
  if constexpr (P::kT32 > 0)
    wgmma_rs<32>(d + P::col(P::kN0) / 2, fa, tail(P::kN0));
  if constexpr (P::kT16 > 0)
    wgmma_rs<16>(d + P::col(P::kCount - 1) / 2, fa, tail(P::kCount - 1));
}

// an m64nN accumulator to bf16 A fragments: k16 step kk is its n8 blocks
// 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void pack(uint32_t (&fa)[N / 8][4],
                                     const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      fa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// the (b, row, h) row of a (B, S, H, HD) tensor: an accumulator's rows
// (row0, row0 + 8) written as bf16, times mul
template <int HD>
__device__ __forceinline__ void store_rows(void* dst, const float (&acc)[HD / 2],
                                           float mul, int b, int row0, int S,
                                           int H, int h, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    if (pos >= S) continue;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dst) +
                         ((static_cast<long long>(b) * S + pos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                acc[4 * j + 2 * r + 1] * mul);
  }
}

// dK/dV shared memory (bytes from a 1024-aligned base): K and V tiles of
// kBKV rows, the ring's Q and dO tiles of kBQ rows, each stage's lse and D
// (kBQ floats each), the barriers (full and empty per stage, K/V's)
template <int HD>
struct DkdvSmem {
  static constexpr int kS = stages<HD>();
  static constexpr int kKV = kBKV * HD * 2;   // a K or V tile
  static constexpr int kQT = kBQ * HD * 2;    // a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;          // + stage * kQT
  static constexpr int kDO = kQ + kS * kQT;    // + stage * kQT
  static constexpr int kStat = kDO + kS * kQT;  // + stage * kStatBytes
  static constexpr int kStatBytes = 2 * kBQ * 4;   // lse, then D
  static constexpr int kFull = kStat + kS * kStatBytes;
  static constexpr int kEmpty = kFull + 8 * kS;
  static constexpr int kKVFull = kEmpty + 8 * kS;
  static constexpr int kBytes = kKVFull + 8 + 1024;  // + alignment slack
};

// dQ shared memory: Q and dO tiles of kQRows rows, the ring's K and V
// tiles of kKVRows, the barriers (full and empty per stage, Q/dO's)
template <int HD>
struct DqSmem {
  static constexpr int kS = stages<HD>();
  static constexpr int kQT = kQRows * HD * 2;
  static constexpr int kKV = kKVRows * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQT;
  static constexpr int kK = kDO + kQT;         // + stage * kKV
  static constexpr int kV = kK + kS * kKV;     // + stage * kKV
  static constexpr int kFull = kV + kS * kKV;
  static constexpr int kEmpty = kFull + 8 * kS;
  static constexpr int kQFull = kEmpty + 8 * kS;
  static constexpr int kBytes = kQFull + 8 + 1024;
};

// one tensor map per part width (Parts::map) of q, k, v and dO; the box
// rows are the launch's (dK/dV: q and dO kBQ, k and v kBKV; dQ: q and dO
// kQRows, k and v kKVRows)
struct Maps {
  CUtensorMap q[3], k[3], v[3], d[3];
};

// dK (if DK) and dV (if DV) of kv rows [kv0, kv0 + kBKV) of kv head
// blockIdx.x of batch blockIdx.y. The tile is blockIdx.z, the slowest
// index of the launch order: every first tile (the most q rows to see)
// starts before any second one, so the longest walks start first
template <int HD, bool DV, bool DK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ Maps maps, Args a) {
  using P = Parts<HD>;
  using L = DkdvSmem<HD>;
  constexpr int kS = L::kS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_full = base + L::kFull, bar_empty = base + L::kEmpty;
  const uint32_t bar_kv = base + L::kKVFull;

  const int kv0 = blockIdx.z * kBKV;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = a.Hq / a.Hkv;
  const int first = dkdv_first(a, kv0);
  const int per_head = cdiv(a.Sq, kBQ) - first;
  const int n_steps = dkdv_steps(a, kv0);
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(bar_full + 8 * st, 1);                 // the producer
      mbar_init(bar_empty + 8 * st, 4 * kConsumers);   // each consumer warp
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: K and V once, then the ring of Q, dO, lse and D by step
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_steps > 0) {
      mbar_expect_tx(bar_kv, (DK ? 2 : 1) * L::kKV);
#pragma unroll
      for (int p = 0; p < P::kCount; ++p) {
        const uint32_t off = kBKV * 2 * P::col(p);
        tma_load(base + L::kK + off, &maps.k[P::map(p)], bar_kv, P::col(p),
                 hk, kv0, b);
        if (DK)
          tma_load(base + L::kV + off, &maps.v[P::map(p)], bar_kv,
                   P::col(p), hk, kv0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % kS;
        if (i >= kS)   // the consumers released the stage's last step
          mbar_wait(bar_empty + 8 * st, (i / kS - 1) & 1);
        const int h = hk * group + i / per_head;
        const int q0 = (first + i % per_head) * kBQ;
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kQT + L::kStatBytes);
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) {
          const int m = P::map(p);
          const uint32_t off = st * L::kQT + kBQ * 2 * P::col(p);
          tma_load(base + L::kQ + off, &maps.q[m], full, P::col(p), h, q0, b);
          tma_load(base + L::kDO + off, &maps.d[m], full, P::col(p), h, q0,
                   b);
        }
        const long long row = (static_cast<long long>(b) * a.Hq + h) *
                              a.Sq_pad + q0;
        const uint32_t stat = base + L::kStat + st * L::kStatBytes;
        bulk_load(stat, a.lse_p + row, kBQ * 4, full);
        bulk_load(stat + kBQ * 4, a.dsum + row, kBQ * 4, full);
      }
    }
    return;
  }

  // consumer c: kv rows [kv0 + 64c, kv0 + 64c + 64), 16 per warp; the
  // thread's rows are row0 and row0 + 8, its q columns 8j + 2 t4 + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kv_lo = kv0 + 64 * c;
  const int row0 = kv_lo + 16 * ((threadIdx.x >> 5) & 3) + g;
  const float cl = a.scale * kLog2e;

  float dv[HD / 2], dk[HD / 2];   // n8 block j: [4j .. 4j + 3]
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dv[i] = dk[i] = 0.f;
  if (n_steps > 0) mbar_wait(bar_kv, 0);

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kS;
    const int q0 = (first + i % per_head) * kBQ;
    const uint32_t q_s = base + L::kQ + st * L::kQT;
    const uint32_t do_s = base + L::kDO + st * L::kQT;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::kStat + st * L::kStatBytes);
    const float* d_s = lse_s + kBQ;
    float s[kBQ / 2], dp[kBQ / 2];   // S^T and dP^T: n8 block j is q cols
    mbar_wait(bar_full + 8 * st, (i / kS) & 1);
    wgmma_fence();
    ss_product<HD, kBKV, kBQ>(s, base + L::kK, 64 * c, q_s);
    if constexpr (DK) ss_product<HD, kBKV, kBQ>(dp, base + L::kV, 64 * c, do_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    if constexpr (DK) fence_regs(dp);

    // P^T = 2^(S^T c log2 e - lse) (0 where kv_pos > q_pos, causally);
    // dS^T = P^T (dP^T - D)
    const bool mask = a.causal && kv_lo + 63 > q0;
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
      const float2 dd = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const int q_pos = q0 + 8 * j + 2 * t4 + (e & 1);
        float p = exp2_ftz(fmaf(s[x], cl, -((e & 1) ? ls.y : ls.x)));
        if (mask && row0 + 8 * (e >> 1) > q_pos) p = 0.f;
        s[x] = p;
        if constexpr (DK) dp[x] = dscore(p, dp[x], (e & 1) ? dd.y : dd.x);
      }
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    if constexpr (DV) pack(pa, s);     // P^T: dV's A operand
    if constexpr (DK) pack(da, dp);    // dS^T: dK's A operand
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      if constexpr (DV) rs_step<HD, kBQ>(dv, pa[kk], do_s, kk);  // += P^T dO
      if constexpr (DK) rs_step<HD, kBQ>(dk, da[kk], q_s, kk);   // += dS^T Q
    }
    wgmma_commit();
    wgmma_wait0();
    if constexpr (DV) fence_regs(dv);
    if constexpr (DK) fence_regs(dk);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // this warp is done
  }

  if constexpr (DK) store_rows<HD>(a.dk, dk, a.scale, b, row0, a.Skv, a.Hkv, hk, t4);
  if constexpr (DV) store_rows<HD>(a.dv, dv, 1.f, b, row0, a.Skv, a.Hkv, hk, t4);
}

// dQ of q rows [q0, q0 + kQRows) of q head blockIdx.x of batch blockIdx.y;
// the tile from blockIdx.z, last tiles (the most kv rows to see) first
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ Maps maps, Args a) {
  using P = Parts<HD>;
  using L = DqSmem<HD>;
  constexpr int kS = L::kS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kFull, bar_empty = base + L::kEmpty;
  const uint32_t bar_q = base + L::kQFull;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int n_tiles = visible_tiles<kQRows, kKVRows>(a, q0);
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: Q and dO once, then the ring of K and V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * L::kQT);
#pragma unroll
      for (int p = 0; p < P::kCount; ++p) {
        const uint32_t off = kQRows * 2 * P::col(p);
        tma_load(base + L::kQ + off, &maps.q[P::map(p)], bar_q, P::col(p), h,
                 q0, b);
        tma_load(base + L::kDO + off, &maps.d[P::map(p)], bar_q, P::col(p),
                 h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kS;
        if (t >= kS) mbar_wait(bar_empty + 8 * st, (t / kS - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kKV);
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) {
          const int m = P::map(p);
          const uint32_t off = st * L::kKV + kKVRows * 2 * P::col(p);
          tma_load(base + L::kK + off, &maps.k[m], bar_full + 8 * st,
                   P::col(p), hk, t * kKVRows, b);
          tma_load(base + L::kV + off, &maps.v[m], bar_full + 8 * st,
                   P::col(p), hk, t * kKVRows, b);
        }
      }
    }
    return;
  }

  // consumer c: q rows [q0 + 64c, q0 + 64c + 64), 16 per warp; the
  // thread's rows row0 and row0 + 8, its kv columns 8j + 2 t4 + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_lo = q0 + 64 * c;
  const int row0 = q_lo + 16 * ((threadIdx.x >> 5) & 3) + g;
  const float cl = a.scale * kLog2e;
  float lse_r[2], d_r[2];   // padded rows: +inf and 0, so P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = (static_cast<long long>(b) * a.Hq + h) * a.Sq_pad +
                          row0 + 8 * r;
    lse_r[r] = a.lse_p[row];
    d_r[r] = a.dsum[row];
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kS;
    const int kv0 = t * kKVRows;
    const uint32_t k_s = base + L::kK + st * L::kKV;
    const uint32_t v_s = base + L::kV + st * L::kKV;
    float s[kKVRows / 2], dp[kKVRows / 2];   // n8 block j is kv cols
    mbar_wait(bar_full + 8 * st, (t / kS) & 1);
    wgmma_fence();
    ss_product<HD, kQRows, kKVRows>(s, base + L::kQ, 64 * c, k_s);
    ss_product<HD, kQRows, kKVRows>(dp, base + L::kDO, 64 * c, v_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool mask = kv0 + kKVRows > a.Skv ||
                      (a.causal && kv0 + kKVRows - 1 > q_lo);
#pragma unroll
    for (int x = 0; x < kKVRows / 2; ++x) {
      const int r = (x >> 1) & 1;
      const int kv_pos = kv0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
      float p = exp2_ftz(fmaf(s[x], cl, -lse_r[r]));
      if (mask && (kv_pos >= a.Skv || (a.causal && kv_pos > row0 + 8 * r)))
        p = 0.f;
      dp[x] = dscore(p, dp[x], d_r[r]);
    }
    uint32_t da[kKVRows / 16][4];
    pack(da, dp);   // dS: dQ's A operand
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKVRows / 16; ++kk)
      rs_step<HD, kKVRows>(dq, da[kk], k_s, kk);   // dQ += dS K
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

  store_rows<HD>(a.dq, dq, a.scale, b, row0, a.Sq, a.Hq, h, t4);
}

// ---------------------------------------------------------- tensor maps --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime so that
// the library does not link libcuda; null if the installed one has none
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the (hd, H, S, B) view of a contiguous (B, S, H, hd) bf16 tensor, in
// boxes of `width` columns by `rows` rows of one head, swizzled as wide as
// a box row (zeros outside the tensor)
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd, int H,
            int S, int B, int width, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * H, 2ull * hd * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(width), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t launch_tma(Kernel kernel, int smem, dim3 grid, const Maps& maps,
                       const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// the tensor maps of q and dO in boxes of q_rows rows, k and v in boxes of
// kv_rows
template <int HD>
bool encode_maps(EncodeTiled fn, Maps* maps, const Args& a, int q_rows,
                 int kv_rows) {
  using P = Parts<HD>;
  const int n_maps = 1 + P::kCount - P::kN0;
  for (int m = 0; m < n_maps; ++m) {
    const int width = P::width(m == 0 ? 0 : P::kN0 + m - 1);
    if (!encode(fn, &maps->q[m], a.q, HD, a.Hq, a.Sq, a.B, width, q_rows) ||
        !encode(fn, &maps->d[m], a.dout, HD, a.Hq, a.Sq, a.B, width,
                q_rows) ||
        !encode(fn, &maps->k[m], a.k, HD, a.Hkv, a.Skv, a.B, width,
                kv_rows) ||
        !encode(fn, &maps->v[m], a.v, HD, a.Hkv, a.Skv, a.B, width, kv_rows))
      return false;
  }
  for (int m = n_maps; m < 3; ++m)   // unused: never read by a copy
    maps->q[m] = maps->d[m] = maps->k[m] = maps->v[m] = maps->q[0];
  return true;
}

template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps kv_maps, q_maps;
  if (!encode_maps<HD>(fn, &kv_maps, a, kBQ, kBKV) ||
      !encode_maps<HD>(fn, &q_maps, a, kQRows, kKVRows))
    return cudaErrorInvalidValue;
  const dim3 kv_grid(a.Hkv, a.B, cdiv(a.Skv, kBKV));
  const int kv_smem = DkdvSmem<HD>::kBytes;
  cudaError_t err;
  if constexpr (HD > 128) {   // dV, then dK: both do not fit the registers
    err = launch_tma(flash_bwd_dkdv_bf16<HD, true, false>, kv_smem,
                         kv_grid, kv_maps, a, stream);
    if (err != cudaSuccess) return err;
    err = launch_tma(flash_bwd_dkdv_bf16<HD, false, true>, kv_smem,
                         kv_grid, kv_maps, a, stream);
  } else {
    err = launch_tma(flash_bwd_dkdv_bf16<HD, true, true>, kv_smem,
                         kv_grid, kv_maps, a, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_tma(flash_bwd_dq_bf16<HD>, DqSmem<HD>::kBytes,
                        dim3(a.Hq, a.B, cdiv(a.Sq, kQRows)), q_maps, a,
                        stream);
}

// ----------------------------------------------------------------- f32 --

constexpr int kF32Rows = 64;       // rows a tile
constexpr int kF32Threads = 2 * kF32Rows;   // a thread pair a row
constexpr int kCols = kF32Rows / 2;         // score columns a thread

// rows [s0, s0 + 64) of head h of batch b of a (B, S, H, HD) float32 tensor
// into shared memory with row stride LD elements, zeros past row S - 1.
// 16-byte loads; HD * 4 is a multiple of 16.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int s0, int S, int H, int h) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < kF32Rows * kPerRow; i += kF32Threads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<long long>(b) * S + s) * H + h) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// x[j] = row . tile row (2j + half) over HD columns, for j < kCols
template <int HD, int LD>
__device__ __forceinline__ void row_dots(float (&x)[kCols], const float* row,
                                         const float* tile, int half) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) x[j] = 0.f;
  for (int d = 0; d < HD; ++d) {
    const float rd = row[d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] += rd * tile[(2 * j + half) * LD + d];
  }
}

// acc[j] (column 2j + half) += sum over the tile's rows c of w[c] tile[c]
template <int HD, int LD>
__device__ __forceinline__ void add_rows(float (&acc)[HD / 2], const float* w,
                                         const float* tile, int half) {
  for (int c = 0; c < kF32Rows; ++c) {
    const float wc = w[c];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] += wc * tile[c * LD + 2 * j + half];
  }
}

template <int HD>
__device__ __forceinline__ void store_row(void* dst, const float (&acc)[HD / 2],
                                          float mul, int b, int pos, int S,
                                          int H, int h, int half) {
  if (pos >= S) return;
  float* out = static_cast<float*>(dst) +
               ((static_cast<long long>(b) * S + pos) * H + h) * HD;
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) out[2 * j + half] = acc[j] * mul;
}

constexpr int kLdW = kF32Rows + 4;   // a row of P or dS in shared memory

// dK/dV shared memory: K (and V if DK) of the block's 64 kv rows, the
// step's Q and dO tiles, P (if DV) and dS (if DK) by kv row, lse and D
template <int HD, bool DV, bool DK>
struct F32DkdvSmem {
  static constexpr int kLd = HD + 4;   // floats (16-byte pad)
  static constexpr int kTile = kF32Rows * kLd * 4;
  static constexpr int kWTile = kF32Rows * kLdW * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + (DK ? kTile : 0);
  static constexpr int kDO = kQ + kTile;
  static constexpr int kP = kDO + kTile;
  static constexpr int kDS = kP + (DV ? kWTile : 0);
  static constexpr int kLse = kDS + (DK ? kWTile : 0);
  static constexpr int kD = kLse + kF32Rows * 4;
  static constexpr int kBytes = kD + kF32Rows * 4;
};

template <int HD, bool DV, bool DK>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkdv_f32(Args a) {
  using L = F32DkdvSmem<HD, DV, DK>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Ks = reinterpret_cast<float*>(smem + L::kK);
  auto* Vs = reinterpret_cast<float*>(smem + L::kV);
  auto* Qs = reinterpret_cast<float*>(smem + L::kQ);
  auto* Gs = reinterpret_cast<float*>(smem + L::kDO);
  auto* Ps = reinterpret_cast<float*>(smem + L::kP);
  auto* Ss = reinterpret_cast<float*>(smem + L::kDS);
  auto* Ls = reinterpret_cast<float*>(smem + L::kLse);
  auto* Ds = reinterpret_cast<float*>(smem + L::kD);

  const int kv0 = blockIdx.x * kF32Rows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int first = dkdv_first(a, kv0);
  const int per_head = cdiv(a.Sq, kBQ) - first;
  const int n_steps = dkdv_steps(a, kv0);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int kv_pos = kv0 + row;
  const float cl = a.scale * kLog2e;

  load_tile<HD, kLd>(Ks, static_cast<const float*>(a.k), b, kv0, a.Skv,
                     a.Hkv, hk);
  if (DK)
    load_tile<HD, kLd>(Vs, static_cast<const float*>(a.v), b, kv0, a.Skv,
                       a.Hkv, hk);
  float dv[HD / 2], dk[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) dv[j] = dk[j] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int h = hk * group + i / per_head;
    const int q0 = (first + i % per_head) * kBQ;
    __syncthreads();   // the last step's tiles are read
    load_tile<HD, kLd>(Qs, static_cast<const float*>(a.q), b, q0, a.Sq, a.Hq,
                       h);
    load_tile<HD, kLd>(Gs, static_cast<const float*>(a.dout), b, q0, a.Sq,
                       a.Hq, h);
    {
      const long long srow = (static_cast<long long>(b) * a.Hq + h) *
                             a.Sq_pad + q0 + row;
      if (half == 0) Ls[row] = a.lse_p[srow];
      else Ds[row] = a.dsum[srow];
    }
    __syncthreads();

    float x[kCols], y[kCols];
    row_dots<HD, kLd>(x, Ks + row * kLd, Qs, half);          // S^T
    if (DK) row_dots<HD, kLd>(y, Vs + row * kLd, Gs, half);  // dP^T
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = 2 * j + half;
      const bool ok = !a.causal || kv_pos <= q0 + col;
      const float p = ok ? exp2f(fmaf(x[j], cl, -Ls[col])) : 0.f;
      if (DV) Ps[row * kLdW + col] = p;
      if (DK) Ss[row * kLdW + col] = dscore(p, y[j], Ds[col]);
    }
    __syncwarp();   // a row's pair lies in one warp
    if (DV) add_rows<HD, kLd>(dv, Ps + row * kLdW, Gs, half);   // P^T dO
    if (DK) add_rows<HD, kLd>(dk, Ss + row * kLdW, Qs, half);   // dS^T Q
  }

  if (DK) store_row<HD>(a.dk, dk, a.scale, b, kv_pos, a.Skv, a.Hkv, hk, half);
  if (DV) store_row<HD>(a.dv, dv, 1.f, b, kv_pos, a.Skv, a.Hkv, hk, half);
}

// dQ shared memory: Q and dO of the block's 64 q rows, the tile's K and
// V, dS by q row
template <int HD>
struct F32DqSmem {
  static constexpr int kLd = HD + 4;
  static constexpr int kTile = kF32Rows * kLd * 4;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kK = kDO + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kDS = kV + kTile;
  static constexpr int kBytes = kDS + kF32Rows * kLdW * 4;
};

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32(Args a) {
  using L = F32DqSmem<HD>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Qs = reinterpret_cast<float*>(smem + L::kQ);
  auto* Gs = reinterpret_cast<float*>(smem + L::kDO);
  auto* Ks = reinterpret_cast<float*>(smem + L::kK);
  auto* Vs = reinterpret_cast<float*>(smem + L::kV);
  auto* Ss = reinterpret_cast<float*>(smem + L::kDS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int q_pos = q0 + row;
  const float cl = a.scale * kLog2e;
  const long long srow = (static_cast<long long>(b) * a.Hq + h) * a.Sq_pad +
                         q_pos;
  const float lse = a.lse_p[srow], d = a.dsum[srow];

  load_tile<HD, kLd>(Qs, static_cast<const float*>(a.q), b, q0, a.Sq, a.Hq,
                     h);
  load_tile<HD, kLd>(Gs, static_cast<const float*>(a.dout), b, q0, a.Sq,
                     a.Hq, h);
  float dq[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) dq[j] = 0.f;

  const int n_tiles = visible_tiles<kF32Rows, kF32Rows>(a, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kF32Rows;
    __syncthreads();
    load_tile<HD, kLd>(Ks, static_cast<const float*>(a.k), b, kv0, a.Skv,
                       a.Hkv, hk);
    load_tile<HD, kLd>(Vs, static_cast<const float*>(a.v), b, kv0, a.Skv,
                       a.Hkv, hk);
    __syncthreads();

    float x[kCols], y[kCols];
    row_dots<HD, kLd>(x, Qs + row * kLd, Ks, half);   // S
    row_dots<HD, kLd>(y, Gs + row * kLd, Vs, half);   // dP
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kv_pos = kv0 + 2 * j + half;
      const bool ok = kv_pos < a.Skv && (!a.causal || kv_pos <= q_pos);
      const float p = ok ? exp2f(fmaf(x[j], cl, -lse)) : 0.f;
      Ss[row * kLdW + 2 * j + half] = dscore(p, y[j], d);
    }
    __syncwarp();
    add_rows<HD, kLd>(dq, Ss + row * kLdW, Ks, half);   // dS K
    __syncwarp();   // dS is read before the next tile overwrites it
  }

  store_row<HD>(a.dq, dq, a.scale, b, q_pos, a.Sq, a.Hq, h, half);
}

template <typename Kernel>
cudaError_t launch_plain(Kernel kernel, int smem, dim3 grid, const Args& a,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const dim3 kv_grid(cdiv(a.Skv, kF32Rows), a.Hkv, a.B);
  cudaError_t err;
  if constexpr (HD > 128) {   // dV, then dK, as the bf16 kernels
    err = launch_plain(flash_bwd_dkdv_f32<HD, true, false>,
                       F32DkdvSmem<HD, true, false>::kBytes, kv_grid, a,
                       stream);
    if (err != cudaSuccess) return err;
    err = launch_plain(flash_bwd_dkdv_f32<HD, false, true>,
                       F32DkdvSmem<HD, false, true>::kBytes, kv_grid, a,
                       stream);
  } else {
    err = launch_plain(flash_bwd_dkdv_f32<HD, true, true>,
                       F32DkdvSmem<HD, true, true>::kBytes, kv_grid, a,
                       stream);
  }
  if (err != cudaSuccess) return err;
  return launch_plain(flash_bwd_dq_f32<HD>, F32DqSmem<HD>::kBytes,
                      dim3(cdiv(a.Sq, kF32Rows), a.Hq, a.B), a, stream);
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype, cudaStream_t stream) {
  const int rows = a.B * a.Hq * a.Sq_pad;   // the pre-pass's, kPreRows a block
  if (dtype == 0) {
    flash_bwd_pre<float, HD><<<rows / kPreRows, 8 * kPreRows, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : launch_f32<HD>(a, stream);
  }
  if (dtype == 1) {
    flash_bwd_pre<__nv_bfloat16, HD>
        <<<rows / kPreRows, 8 * kPreRows, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : launch_bf16<HD>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16. q, o and dout (B, Sq, Hq, hd), k and
// v (B, Skv, Hkv, hd), dq, dk, dv like q, k, v, all contiguous and 16-byte
// aligned; lse float32 (B, Hq, Sq) in log2 units (the forward's); lse_p
// and dsum float32 scratch of (B, Hq, Sq_pad) rows, Sq_pad a multiple of
// 128 at least Sq; Hq % Hkv == 0. The head dims are the forward's
// (flash_attention.HEAD_DIMS; a CPU test checks the list).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse_p, float* dsum, void* dq,
    void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
    int Sq_pad, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535 || cdiv(Sq, kQRows) > 65535 ||
      cdiv(Skv, kBKV) > 65535 || Sq_pad < Sq || Sq_pad % kPad != 0 ||
      static_cast<long long>(B) * Hq * Sq_pad >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, lse_p, dsum, dq, dk, dv,
               B, Sq, Skv, Hq, Hkv, Sq_pad, scale, causal};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd == 16) err = launch_hd<16>(a, dtype, s);
  else if (hd == 32) err = launch_hd<32>(a, dtype, s);
  else if (hd == 64) err = launch_hd<64>(a, dtype, s);
  else if (hd == 80) err = launch_hd<80>(a, dtype, s);
  else if (hd == 112) err = launch_hd<112>(a, dtype, s);
  else if (hd == 128) err = launch_hd<128>(a, dtype, s);
  else if (hd == 192) err = launch_hd<192>(a, dtype, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
