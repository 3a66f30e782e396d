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
// Design, bf16 at hd <= 128: a pre-pass, one walk per kv tile, and the
// passes that round its float32 sums; dq, dk and dv are the same bits
// from run to run (every sum runs in a fixed order; no float atomics).
//   flash_bwd_pre: D = rowsum(dO o) in float32, 8 threads a row, into a
//     (B, Hq, Sq_pad) scratch beside a copy of lse (Sq_pad: Sq rounded up
//     to kPad); past Sq, D = 0 and lse = +inf, so a padded row has P = 0.
//     It also zeroes the walk's count of each 64-row dQ tile.
//   flash_bwd_walk_bf16: a block owns 128 kv rows of one (batch, kv head)
//     and walks the 64-row q tiles that can see them, for its rank's share
//     of the GQA group's q heads (Args::split ranks a group, chosen by the
//     wrapper's bwd_plan so that the longest walk is within the balanced
//     share: internvl2's GQA 7 at batch 2 takes 3). Last q tile first,
//     every head of the share at a tile before the next. Each consumer
//     warpgroup owns 64 kv rows; per step (q tile, head), P and dS once,
//     five products, kv rows as M where they are the rows of the result:
//       S^T = K Q^T and dP^T = V dO^T (m64n64k16; K, V, Q and dO K-major
//       in shared memory, the forward's S = Q K^T), P^T and dS^T
//       elementwise in registers; dV += P^T dO and dK += dS^T Q (P^T and
//       dS^T packed to bf16 as the A operand from registers, dO and Q
//       MN-major: the forward's P V); dS^T also into shared memory as bf16
//       (kv rows of 128 bytes, 128-byte swizzle: the rounding dK's operand
//       already has), and dQ's partial over the consumer's 64 kv rows,
//       dS K with q rows as M, A and B both MN-major from shared memory.
//     dK and dV add up in registers over the whole walk. Consumer 0 stages
//     its dQ partial (64 x hd float32, in the fragments' order) in a
//     shared tile, consumer 1 adds its own onto it, and a writer (lane 0
//     of a producer warp, one a staging tile, up to three) stores kv tile
//     0's into a float32 (B, Hq, Sq_pad, hd) scratch and adds each later
//     kv tile's with one bulk reduce, after the tile's count shows that
//     the kv tiles before it have added theirs; then it waits for the add
//     to land and counts it. So each dQ element sums its partials in a
//     fixed order: the two consumers', then kv tile by kv tile. The kv
//     tile is blockIdx.z, the slowest index: the blocks waited on are
//     launched earlier, and under the causal mask the longest walks (the
//     first kv tiles) start first. As every kv tile reaches a q tile at
//     the same step of its walk, a wait is about one add; a count that
//     stands still for seconds traps. The consumers share no barrier.
//   flash_bwd_post_dq: dq = c times the float32 sums, rounded to bf16.
//   flash_bwd_post_kv (split > 1 only): dk and dv from the ranks' float32
//     partials, summed in rank order.
//   Shared memory: K and V, a ring of Q and dO tiles with their rows' lse
//   and D (3 stages; 2 at hd 128), the dS^T tile, dQ staging tiles (3 up
//   to hd 80, 2 above), within the 227 KB a block may have. Live
//   registers of a consumer thread, about: hd (dK and dV) + 64 (S^T and
//   dP^T, packed into 32 as they die) + hd / 2 (the dQ partial; above hd
//   80 after P^T and dS^T have gone), 192 at hd 128.
//   Built with -DFLASH_BWD_PROFILE, the walk also keeps its own cycle
//   counters by phase (ProfSlot; flash_attention_bwd_profile reads them).
// Above hd 128 (deepseek's MLA at 192), dK and dV (hd / 2 float32
// registers each) do not fit beside S^T and dP^T, nor does a walk's shared
// memory (K and V 96 KB, a ring stage 48 KB, the dQ staging tile 48 KB),
// so PR 23's three walks stay: flash_bwd_dkdv_bf16 for dV (products S,
// dV), again for dK (S, dP, dK), then flash_bwd_dq_bf16, a block per 128
// q rows of one head walking the 64-row kv tiles they see (S, dP, dQ +=
// dS K), seven products in all, no atomics.
//   The bf16 kernels have the forward's shape: warpgroup 0 produces (one
//   thread starts every copy; setmaxnreg.dec 24), warpgroups 1 and 2
//   consume (setmaxnreg.inc 240); a ring with a full and an empty mbarrier
//   a stage; the forward's column parts (Parts<HD>: 64-column boxes with a
//   128-byte swizzle, tails of 32 and 16 columns at hd 80 and 112) and its
//   tensor maps. ptxas reports registers and spills of every
//   instantiation; chip_smoke.py prints them and asserts that no bf16 one
//   spills. The roundings against the plain version: P and dS to bf16 as
//   the products' operands, and the results to bf16.
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

#include <type_traits>

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
  float* dq_acc;      // the walk's (B, Hq, Sq_pad / 64) dQ tiles, float32
  int* sem;           // the walk's count of partials added, per dQ tile
  float* kv_part;     // the walk's (split, 2, B, Skv, Hkv, hd) dK, dV
  int B, Sq, Skv, Hq, Hkv, Sq_pad;
  int split;          // the walk's ranks per (batch, kv head, kv tile)
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
    // the walk's count for the 64-row dQ tile that starts here
    if (a.sem != nullptr && qi % 64 == 0) a.sem[row / 64] = 0;
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

// D (+)= A B for one m64nNk16 step, A and B both MN-major in shared memory
// (descriptors; the walk's dQ = dS K, dS^T and K stored by kv rows);
// scale_d 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float* d, uint64_t da,
                                            uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_tt<16>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<32>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<64>(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_ss_tt<128>(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
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

// ------------------------------------------- bf16, hd <= 128: one walk --

// rank r's share of a GQA group's q heads: heads [walk_lo(r),
// walk_lo(r + 1)) of the group, so the a.split ranks cover each head once
__device__ __forceinline__ int walk_lo(const Args& a, int r) {
  return r * (a.Hq / a.Hkv) / a.split;
}

__device__ __forceinline__ int walk_heads(const Args& a, int r) {
  const int lo = walk_lo(a, r), hi = walk_lo(a, r + 1);
  return hi - lo;   // the rank's q heads of the GQA group
}

// the q tile of step i of a walk over `heads` heads and n_q tiles: the
// last tile first, each head of the share at a tile before the next
// tile; the head is i % heads. Every kv tile that sees a q tile reaches
// it at the same step of its walk, so the ordered dQ sum waits little
__device__ __forceinline__ int walk_tile(int i, int heads, int n_q) {
  return n_q - 1 - i / heads;
}

// the walk's shared memory: K and V tiles of kBKV rows; a ring of S stages
// of Q and dO tiles of kBQ rows with their rows' lse and D; the dS^T tile
// (kBKV x kBQ bf16 by kv rows of 128 bytes, 128-byte swizzle; a consumer
// its 64 rows); NB dQ staging tiles (kBQ x HD float32 in the fragments'
// order); the barriers (full and empty per stage, K/V's, and per dQ tile
// full, empty, and consumer 0's half staged)
template <int HD, int S, int NB>
struct WalkLayout {
  static constexpr int kS = S, kNB = NB;
  static constexpr int kKV = kBKV * HD * 2;
  static constexpr int kQT = kBQ * HD * 2;
  static constexpr int kStatBytes = 2 * kBQ * 4;   // lse, then D
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;
  static constexpr int kDO = kQ + kS * kQT;
  static constexpr int kStat = kDO + kS * kQT;
  static constexpr int kDSBytes = kBKV * kBQ * 2;
  static constexpr int kDS = (kStat + kS * kStatBytes + 1023) / 1024 * 1024;
  static constexpr int kDQBytes = kBQ * HD * 4;
  static constexpr int kDQ = kDS + kDSBytes;
  static constexpr int kFull = kDQ + kNB * kDQBytes;
  static constexpr int kEmpty = kFull + 8 * kS;
  static constexpr int kKVFull = kEmpty + 8 * kS;
  static constexpr int kDqFull = kKVFull + 8;
  static constexpr int kDqEmpty = kDqFull + 8 * kNB;
  static constexpr int kDqHalf = kDqEmpty + 8 * kNB;
  static constexpr int kBytes = kDqHalf + 8 * kNB + 1024;  // + alignment slack
};

constexpr int kMaxSmem = 232448;   // the dynamic shared memory a block may have

// three ring stages and three dQ tiles (one writer each) where they fit,
// else fewer: hd 80 and below 3 and 3, hd 112 3 and 2, hd 128 2 and 2
template <int HD, int S, int NB>
constexpr bool kFits = WalkLayout<HD, S, NB>::kBytes <= kMaxSmem;

template <int HD>
using WalkSmem = std::conditional_t<
    kFits<HD, 3, 3>, WalkLayout<HD, 3, 3>,
    std::conditional_t<kFits<HD, 3, 2>, WalkLayout<HD, 3, 2>,
                       WalkLayout<HD, 2, 2>>>;

// The walk's own counters, built only with -DFLASH_BWD_PROFILE: clock64
// cycles by phase of one thread of each consumer and of writer 0 a block,
// kept in registers and added once at the end, summed over the blocks
// (flash_attention_bwd_profile reads and clears them)
enum ProfSlot {
  kProfSetup,      // consumer: from the block's start to K/V's arrival
  kProfWalk,       // consumer: the whole walk, from K/V's arrival
  kProfFull,       // consumer: waiting for a ring stage
  kProfSdp,        // consumer: S^T and dP^T
  kProfSoftmax,    // consumer: P^T, dS^T, packing, dS^T to shared memory
  kProfGrads,      // consumer: dV, dK and dQ's partial
  kProfHalf,       // consumer 1: waiting for consumer 0's staged half
  kProfStage,      // consumer: waiting for a staging tile, staging
  kProfEpilogue,   // consumer: dK and dV's stores
  kProfWriter,     // writer 0: from its start to its end
  kProfDqFull,     // writer 0: waiting for a staged partial
  kProfCount,      // writer 0: waiting for the kv tiles before
  kProfBulk,       // writer 0: the bulk copy's read and completion
  kProfSteps,      // steps walked (consumer)
  kProfSlots
};

#ifdef FLASH_BWD_PROFILE
__device__ unsigned long long g_prof[kProfSlots];

__device__ __forceinline__ long long prof_clock() { return clock64(); }

struct Prof {
  bool on;
  long long t0, t;
  long long sum[kProfSlots];
  __device__ explicit Prof(bool on_) : on(on_), t0(prof_clock()), t(t0), sum{} {}
  // add the cycles since the last lap to slot
  __device__ __forceinline__ void lap(int slot) {
    const long long now = prof_clock();
    sum[slot] += now - t;
    t = now;
  }
  // add the cycles since the start to slot
  __device__ __forceinline__ void total(int slot) {
    sum[slot] += prof_clock() - t0;
  }
  __device__ __forceinline__ void add(int slot, long long n) { sum[slot] += n; }
  __device__ __forceinline__ void flush() {
    if (!on) return;
    for (int i = 0; i < kProfSlots; ++i)
      if (sum[i]) atomicAdd(&g_prof[i], static_cast<unsigned long long>(sum[i]));
  }
};
#else
struct Prof {
  __device__ explicit Prof(bool) {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void total(int) {}
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void flush() {}
};
#endif

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// a wait on a dQ tile's count that sees no progress for this long traps
constexpr uint64_t kStallNs = 4000000000ull;

// wait until the count of partials added to a dQ tile reaches `want` (the
// kv tiles before this one have added theirs). The count only grows, and
// the blocks waited on come earlier in launch order (a smaller
// blockIdx.z), so they run or have run; a count that stands still for
// kStallNs traps, so a fault ends the launch with an error rather than
// holding the card
__device__ __forceinline__ void wait_count(const int* count, int want) {
  int seen = ld_acquire(count);
  uint64_t since = global_ns();
  while (seen < want) {
    __nanosleep(32);
    const int now = ld_acquire(count);
    if (now != seen) {
      seen = now;
      since = global_ns();
    } else if (global_ns() - since > kStallNs) {
      asm volatile("trap;\n");
    }
  }
}

// bulk copies from shared memory to global memory (a bulk async-group)
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the group's reads of shared memory are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the group's writes to global memory are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// this thread's stores to shared memory, before wgmma or a bulk copy
// reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dS^T's A fragments (pack's order) into the kBKV x kBQ bf16 tile at ds,
// by kv rows of 128 bytes with the 128-byte swizzle (16-byte chunk k of
// row r at chunk k ^ (r % 8), as TMA writes Q and dO): the thread's kv
// rows r and r + 8 (r % 8 == g), q columns 16 kk + 8 (e / 2) + 2 t4 and + 1
__device__ __forceinline__ void store_ds(unsigned char* ds,
                                         const uint32_t (&da)[kBQ / 16][4],
                                         int r, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e & 1);
      const int chunk = (2 * kk + (e >> 1)) ^ g;
      *reinterpret_cast<uint32_t*>(ds + row * 128 + chunk * 16 + 4 * t4) =
          da[kk][e];
    }
}

// the partial dS K over a consumer's 64 kv rows, every head-dim column: A
// its rows of the dS^T tile at ds_s (MN-major: q columns contiguous), B
// the same rows of the K tile at k_s (MN-major: head-dim columns
// contiguous; rows from r0), as rs_step's parts: the leading parts as one
// wgmma, each tail part as one of its width; 16 kv rows a step, scale_d 0
// at the first overwriting d
template <int HD>
__device__ __forceinline__ void dq_product(float (&d)[HD / 2], uint32_t ds_s,
                                           uint32_t k_s, int r0) {
  using P = Parts<HD>;
  constexpr int rb = 2 * P::kW0;
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    const uint64_t da = make_desc(ds_s + 16 * kk * 128, 64 * 128, 1024, 128);
    wgmma_ss_tt<P::kN0 * P::kW0>(
        d, da, make_desc(k_s + (r0 + 16 * kk) * rb, kBKV * rb, 8 * rb, rb),
        kk);
    auto tail = [&](int p) {
      const int tb = 2 * P::width(p);
      return make_desc(k_s + kBKV * 2 * P::col(p) + (r0 + 16 * kk) * tb,
                       kBKV * tb, 8 * tb, tb);
    };
    if constexpr (P::kT32 > 0)
      wgmma_ss_tt<32>(d + P::col(P::kN0) / 2, da, tail(P::kN0), kk);
    if constexpr (P::kT16 > 0)
      wgmma_ss_tt<16>(d + P::col(P::kCount - 1) / 2, da,
                      tail(P::kCount - 1), kk);
  }
}

// an m64nHD accumulator into a dQ staging tile: n8 block j of thread t
// (its rows g and g + 8 of warp t / 32, columns 8 j + 2 t4 and + 1) as the
// float4 at 4 (128 j + t); with ADD, onto what is there (consumer 0's)
template <int HD, bool ADD>
__device__ __forceinline__ void stage_dq(float* dst, const float (&d)[HD / 2],
                                         int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    auto* at = reinterpret_cast<float4*>(dst + 4 * (128 * j + t));
    float4 x = make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
    if constexpr (ADD) {
      const float4 y = *at;
      x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
    }
    *at = x;
  }
}

// an accumulator's rows (row0, row0 + 8) of (b, row, h) of a (B, S, H, HD)
// float32 tensor (a rank's partial dK or dV)
template <int HD>
__device__ __forceinline__ void store_part(float* dst,
                                           const float (&acc)[HD / 2], int b,
                                           int row0, int S, int H, int h,
                                           int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    if (pos >= S) continue;
    float* out = dst + ((static_cast<long long>(b) * S + pos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// One walk over kv rows [kv0, kv0 + kBKV) of kv head hk of batch
// blockIdx.y, for the rank's share of the group's q heads (blockIdx.x =
// hk * split + rank): per step (q tile, head) S^T, dP^T, dV += P^T dO,
// dK += dS^T Q and dQ's partial dS K, each consumer over its 64 kv rows
// (consumer 1 adds its partial onto consumer 0's in the staging tile), which
// the writer adds to the tile's float32 sum after the partials of kv tiles
// 0 .. z - 1 (z = blockIdx.z, the slowest index: the first tiles, the
// longest walks under the causal mask, start first, and every block waited
// on was launched earlier). The consumers share no barrier, so one's
// softmax can run beside the other's products
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_walk_bf16(const __grid_constant__ Maps maps, Args a) {
  using P = Parts<HD>;
  using L = WalkSmem<HD>;
  constexpr int kS = L::kS, kNB = L::kNB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_full = base + L::kFull, bar_empty = base + L::kEmpty;
  const uint32_t bar_kv = base + L::kKVFull;
  const uint32_t dq_full = base + L::kDqFull, dq_empty = base + L::kDqEmpty;
  const uint32_t dq_half = base + L::kDqHalf;

  const int z = blockIdx.z, kv0 = z * kBKV;
  const int rank = blockIdx.x % a.split, hk = blockIdx.x / a.split;
  const int b = blockIdx.y;
  const int h0 = hk * (a.Hq / a.Hkv) + walk_lo(a, rank);  // the share's first
  const int heads = walk_heads(a, rank);
  const int n_q = cdiv(a.Sq, kBQ);
  const int n_steps = heads * (n_q - dkdv_first(a, kv0));
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
  Prof start(threadIdx.x == 128 || threadIdx.x == 256);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(bar_full + 8 * st, 1);                 // the producer
      mbar_init(bar_empty + 8 * st, 4 * kConsumers);   // each consumer warp
    }
    for (int i = 0; i < kNB; ++i) {
      mbar_init(dq_full + 8 * i, 4);    // each warp of consumer 1
      mbar_init(dq_empty + 8 * i, 1);   // the writer
      mbar_init(dq_half + 8 * i, 4);    // each warp of consumer 0
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (n_steps == 0) return;
    if (threadIdx.x == 0) {
      // producer: K and V once, then the ring of Q, dO, lse and D by step
      mbar_expect_tx(bar_kv, 2 * L::kKV);
#pragma unroll
      for (int p = 0; p < P::kCount; ++p) {
        const uint32_t off = kBKV * 2 * P::col(p);
        tma_load(base + L::kK + off, &maps.k[P::map(p)], bar_kv, P::col(p),
                 hk, kv0, b);
        tma_load(base + L::kV + off, &maps.v[P::map(p)], bar_kv, P::col(p),
                 hk, kv0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % kS;
        if (i >= kS)   // the consumers released the stage's last step
          mbar_wait(bar_empty + 8 * st, (i / kS - 1) & 1);
        const int h = h0 + i % heads;
        const int q0 = walk_tile(i, heads, n_q) * kBQ;
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
    } else if ((threadIdx.x & 31) == 0 && threadIdx.x <= 32 * kNB) {
      // writer w (lane 0 of warp w + 1): the steps staged on tile w, each
      // step's dQ partial into its q tile's float32 sum in kv tile order:
      // kv tile 0 stores, the others add once the count says every kv
      // tile before them has. The kNB writers run at once, so one step's
      // wait for its add to land overlaps the next steps'
      const int w = threadIdx.x / 32 - 1;
      Prof prof(w == 0);
      const int n_qp = a.Sq_pad / kBQ;
      const uint32_t src = base + L::kDQ + w * L::kDQBytes;
      for (int i = w; i < n_steps; i += kNB) {
        mbar_wait(dq_full + 8 * w, (i / kNB) & 1);
        prof.lap(kProfDqFull);
        const long long tile =
            (static_cast<long long>(b) * a.Hq + h0 + i % heads) * n_qp +
            walk_tile(i, heads, n_q);
        float* dst = a.dq_acc + tile * (kBQ * HD);
        if (z > 0) {
          wait_count(a.sem + tile, z);
          fence_async_global();
        }
        prof.lap(kProfCount);
        if (z == 0) bulk_store(dst, src, L::kDQBytes);   // the first partial
        else bulk_reduce_add(dst, src, L::kDQBytes);   // the next in kv order
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(dq_empty + 8 * w);   // the staging tile is free
        bulk_wait();
        fence_async_global();
        red_release_add(a.sem + tile, 1);
        prof.lap(kProfBulk);
      }
      prof.total(kProfWriter);
      prof.flush();
    }
    return;
  }

  // consumer c: kv rows [kv0 + 64c, kv0 + 64c + 64), 16 per warp; the
  // thread's rows are row0 and row0 + 8, its q columns 8j + 2 t4 + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int t = threadIdx.x & 127;   // the thread within its warpgroup
  const int kv_lo = kv0 + 64 * c;
  const int r_tile = 64 * c + 16 * warp + g;   // row0 within the kv tile
  const int row0 = kv0 + r_tile;
  const float cl = a.scale * kLog2e;

  float dv[HD / 2], dk[HD / 2];   // n8 block j: [4j .. 4j + 3]
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dv[i] = dk[i] = 0.f;
  if (n_steps > 0) mbar_wait(bar_kv, 0);
  start.total(kProfSetup);
  start.flush();
  Prof prof(threadIdx.x == 128 || threadIdx.x == 256);
  prof.add(kProfSteps, n_steps);


  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kS;
    const int q0 = walk_tile(i, heads, n_q) * kBQ;
    const uint32_t q_s = base + L::kQ + st * L::kQT;
    const uint32_t do_s = base + L::kDO + st * L::kQT;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::kStat + st * L::kStatBytes);
    const float* d_s = lse_s + kBQ;
    float s[kBQ / 2], dp[kBQ / 2];   // S^T and dP^T: n8 block j is q cols
    mbar_wait(bar_full + 8 * st, (i / kS) & 1);
    prof.lap(kProfFull);
    wgmma_fence();
    ss_product<HD, kBKV, kBQ>(s, base + L::kK, 64 * c, q_s);
    ss_product<HD, kBKV, kBQ>(dp, base + L::kV, 64 * c, do_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    prof.lap(kProfSdp);

    // P^T = 2^(S^T c log2 e - lse), 0 where kv_pos > q_pos (causally) and
    // on kv rows past Skv; dS^T = P^T (dP^T - D)
    const bool edge = (a.causal && kv_lo + 63 > q0) || kv_lo + 64 > a.Skv;
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
      const float2 dd = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const int q_pos = q0 + 8 * j + 2 * t4 + (e & 1);
        const int kv_pos = row0 + 8 * (e >> 1);
        float p = exp2_ftz(fmaf(s[x], cl, -((e & 1) ? ls.y : ls.x)));
        if (edge && (kv_pos >= a.Skv || (a.causal && kv_pos > q_pos))) p = 0.f;
        s[x] = p;
        dp[x] = dscore(p, dp[x], (e & 1) ? dd.y : dd.x);
      }
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    pack(pa, s);    // P^T: dV's A operand
    pack(da, dp);   // dS^T: dK's A operand, and dQ's through shared memory
    // this consumer's rows of dS^T (its dQ product of the step before has
    // read them: it waited for it)
    const uint32_t ds_s = base + L::kDS + 64 * c * 128;
    store_ds(smem + L::kDS, da, r_tile, g, t4);
    fence_async_smem();
    prof.lap(kProfSoftmax);
    float dq[HD / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      rs_step<HD, kBQ>(dv, pa[kk], do_s, kk);   // += P^T dO
      rs_step<HD, kBQ>(dk, da[kk], q_s, kk);    // += dS^T Q
    }
    if constexpr (HD > 80) {   // P^T and dS^T's registers go before dQ's
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
    }
    dq_product<HD>(dq, ds_s, base + L::kK, 64 * c);   // dS K, its kv rows
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // this warp is done
    prof.lap(kProfGrads);

    // the step's dQ partial into staging tile i % kNB: consumer 0's
    // staged, then consumer 1's added to it (a fixed order), then the
    // writer's
    const int buf = i % kNB;
    float* tile = reinterpret_cast<float*>(smem + L::kDQ + buf * L::kDQBytes);
    if (c == 0) {
      if (i >= kNB) mbar_wait(dq_empty + 8 * buf, (i / kNB - 1) & 1);
      prof.lap(kProfStage);
      stage_dq<HD, false>(tile, dq, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_half + 8 * buf);
    } else {
      mbar_wait(dq_half + 8 * buf, (i / kNB) & 1);
      prof.lap(kProfHalf);
      stage_dq<HD, true>(tile, dq, t);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full + 8 * buf);
    }
    prof.lap(kProfStage);
  }
  prof.total(kProfWalk);

  if (a.split == 1) {
    store_rows<HD>(a.dk, dk, a.scale, b, row0, a.Skv, a.Hkv, hk, t4);
    store_rows<HD>(a.dv, dv, 1.f, b, row0, a.Skv, a.Hkv, hk, t4);
  } else {   // the rank's partials, summed in rank order by flash_bwd_post_kv
    const long long n = static_cast<long long>(a.B) * a.Skv * a.Hkv * HD;
    float* part = a.kv_part + 2 * rank * n;
    store_part<HD>(part, dk, b, row0, a.Skv, a.Hkv, hk, t4);
    store_part<HD>(part + n, dv, b, row0, a.Skv, a.Hkv, hk, t4);
  }
  prof.lap(kProfEpilogue);
  prof.flush();
}

constexpr int kPostThreads = 256;

// dq = c times the walk's float32 dQ tiles, rounded to bf16. A thread
// reads one float4 of a tile's staging order (float4 128 j + t: rows
// 16 (t / 32) + g and + 8, columns 8 j + 2 t4 and + 1)
template <int HD>
__global__ void __launch_bounds__(kPostThreads) flash_bwd_post_dq(Args a) {
  constexpr int kPerTile = kBQ * HD / 4;   // float4s a tile
  const long long idx =
      static_cast<long long>(blockIdx.x) * kPostThreads + threadIdx.x;
  const int n_qp = a.Sq_pad / kBQ;
  if (idx >= static_cast<long long>(a.B) * a.Hq * n_qp * kPerTile) return;
  const long long tile = idx / kPerTile;
  const int f = static_cast<int>(idx % kPerTile);
  const int t = f % 128, lane = t & 31;
  const int row = 16 * (t >> 5) + (lane >> 2);
  const int col = 8 * (f / 128) + 2 * (lane & 3);
  const int q0 = static_cast<int>(tile % n_qp) * kBQ;
  const int bh = static_cast<int>(tile / n_qp);
  const int h = bh % a.Hq, b = bh / a.Hq;
  const float4 v = reinterpret_cast<const float4*>(a.dq_acc)[idx];
  auto* out = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row + 8 * r;
    if (pos >= a.Sq) continue;
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((static_cast<long long>(b) * a.Sq + pos) * a.Hq + h) * HD +
        col) = __floats2bfloat162_rn((r ? v.z : v.x) * a.scale,
                                     (r ? v.w : v.y) * a.scale);
  }
}

// dk and dv: the ranks' float32 partials summed in rank order (dk times
// c), rounded to bf16; four elements a thread
template <int HD>
__global__ void __launch_bounds__(kPostThreads) flash_bwd_post_kv(Args a) {
  const long long n = static_cast<long long>(a.B) * a.Skv * a.Hkv * HD;
  const long long i =
      (static_cast<long long>(blockIdx.x) * kPostThreads + threadIdx.x) * 4;
  if (i >= n) return;
  float k[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < a.split; ++r) {
    const float4 pk = *reinterpret_cast<const float4*>(a.kv_part + 2 * r * n + i);
    const float4 pv =
        *reinterpret_cast<const float4*>(a.kv_part + (2 * r + 1) * n + i);
    k[0] += pk.x; k[1] += pk.y; k[2] += pk.z; k[3] += pk.w;
    v[0] += pv.x; v[1] += pv.y; v[2] += pv.z; v[3] += pv.w;
  }
  auto* dk = static_cast<__nv_bfloat16*>(a.dk) + i;
  auto* dv = static_cast<__nv_bfloat16*>(a.dv) + i;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    *reinterpret_cast<__nv_bfloat162*>(dk + e) =
        __floats2bfloat162_rn(k[e] * a.scale, k[e + 1] * a.scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + e) =
        __floats2bfloat162_rn(v[e], v[e + 1]);
  }
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
cudaError_t launch_walk(const Args& a, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps;
  if (!encode_maps<HD>(fn, &maps, a, kBQ, kBKV)) return cudaErrorInvalidValue;
  cudaError_t err = launch_tma(flash_bwd_walk_bf16<HD>, WalkSmem<HD>::kBytes,
                               dim3(a.Hkv * a.split, a.B, cdiv(a.Skv, kBKV)),
                               maps, a, stream);
  if (err != cudaSuccess) return err;
  const long long n_dq = static_cast<long long>(a.B) * a.Hq * a.Sq_pad * HD / 4;
  flash_bwd_post_dq<HD>
      <<<static_cast<unsigned>((n_dq + kPostThreads - 1) / kPostThreads),
         kPostThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  const long long n_kv = static_cast<long long>(a.B) * a.Skv * a.Hkv * HD / 4;
  flash_bwd_post_kv<HD>
      <<<static_cast<unsigned>((n_kv + kPostThreads - 1) / kPostThreads),
         kPostThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  if constexpr (HD <= 128) {
    return launch_walk<HD>(a, stream);
  } else {
    // dV, then dK (both do not fit the registers beside S^T and dP^T),
    // then the dQ walk
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    Maps kv_maps, q_maps;
    if (!encode_maps<HD>(fn, &kv_maps, a, kBQ, kBKV) ||
        !encode_maps<HD>(fn, &q_maps, a, kQRows, kKVRows))
      return cudaErrorInvalidValue;
    const dim3 kv_grid(a.Hkv, a.B, cdiv(a.Skv, kBKV));
    const int kv_smem = DkdvSmem<HD>::kBytes;
    cudaError_t err = launch_tma(flash_bwd_dkdv_bf16<HD, true, false>,
                                 kv_smem, kv_grid, kv_maps, a, stream);
    if (err != cudaSuccess) return err;
    err = launch_tma(flash_bwd_dkdv_bf16<HD, false, true>, kv_smem, kv_grid,
                     kv_maps, a, stream);
    if (err != cudaSuccess) return err;
    return launch_tma(flash_bwd_dq_bf16<HD>, DqSmem<HD>::kBytes,
                      dim3(a.Hq, a.B, cdiv(a.Sq, kQRows)), q_maps, a,
                      stream);
  }
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
// (flash_attention.HEAD_DIMS; a CPU test checks the list). The walk (bf16
// at hd <= 128) also takes dq_acc, float32 scratch of (B, Hq, Sq_pad, hd),
// sem, int32 scratch of B * Hq * Sq_pad / 64, and split, its ranks per GQA
// group (1 <= split <= Hq / Hkv); above 1, kv_part, float32 scratch of
// (split, 2, B, Skv, Hkv, hd). The other paths take split 1 and ignore
// the three.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse_p, float* dsum, void* dq,
    void* dk, void* dv, float* dq_acc, int* sem, float* kv_part, int B,
    int Sq, int Skv, int Hq, int Hkv, int hd, int Sq_pad, int split,
    float scale, int causal, int dtype, void* stream) {
  const bool walk = dtype == 1 && hd <= 128;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535 || cdiv(Sq, kQRows) > 65535 ||
      cdiv(Skv, kBKV) > 65535 || Sq_pad < Sq || Sq_pad % kPad != 0 ||
      static_cast<long long>(B) * Hq * Sq_pad >= (1ll << 31) || split < 1 ||
      (walk ? split > Hq / Hkv || dq_acc == nullptr || sem == nullptr ||
                  (split > 1 && kv_part == nullptr)
            : split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, lse_p, dsum, dq, dk, dv,
               walk ? dq_acc : nullptr, walk ? sem : nullptr,
               walk ? kv_part : nullptr, B, Sq, Skv, Hq, Hkv, Sq_pad, split,
               scale, causal};
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

// the walk's counters (ProfSlot order) into out[kProfSlots], then zeroed;
// cudaErrorNotSupported unless built with -DFLASH_BWD_PROFILE
extern "C" int flash_attention_bwd_profile(unsigned long long* out) {
#ifdef FLASH_BWD_PROFILE
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[kProfSlots] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros)));
#else
  (void)out;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
