// Flash attention forward (online softmax) on (B, S, H, hd), for Hopper
// (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_fwd_kernel (line 30; the
// Pallas TPU kernel behind flash_attention_fwd). Same function: for q
// (B, Sq, Hq, hd) and k, v (B, Skv, Hkv, hd), q head h reads kv head
// h / (Hq / Hkv) (GQA, no repeat), scores scaled by the wrapper's scale
// (hd^-0.5), causal mask kv_pos <= q_pos aligned top-left as the Pallas
// kernel aligns it (the same as the reference's bottom-right mask when
// Sq == Skv), float32 softmax statistics and float32 accumulation, output
// divided by max(l, 1e-30) and rounded to q's type. The plain PyTorch
// version is repro_torch/kernels/ref.py::flash_attention_ref.
//
// What bounds it: operations. Causal attention at qwen3-0.6b's prefill
// shape (B=4, S=4096, 16 heads of 128) is 2.75e11 multiply-adds counted as
// 2 operations (QK^T and PV over the visible half), 0.278 ms at the bf16
// dense tensor-core peak, against 0.06 ms for its bytes. Both kernels walk,
// for one block of query rows of one (batch, head), the kv tiles from the
// first to the last one its rows can see (causal tiles above the diagonal
// are never loaded), longest blocks first; the ragged edge (Sq or Skv not a
// multiple of the tile) is masked here. The Pallas block_q / block_kv do
// not reach the kernel, whose tiles are its own choice.
//
// bfloat16 (the serving path): warp-specialised wgmma with a TMA ring.
//   Block: 128 query rows of one (batch, head), three warpgroups. Warpgroup
//   0 produces: it gives up registers (setmaxnreg.dec 24) and one thread
//   starts every copy by TMA (cp.async.bulk.tensor): Q once, then K and V
//   tiles of 128 kv rows (64 above hd 128) into a ring of kStages = 3
//   stages, each with a full mbarrier (the copies' bytes) and an empty one
//   (one arrival per consumer warp). Warpgroups 1 and 2 consume
//   (setmaxnreg.inc 240), 64 query rows each.
//   Tensor maps over the (hd, H, S, B) view of q, k and v are built on the
//   host per launch with cuTensorMapEncodeTiled, which the runtime hands
//   over (cudaGetDriverEntryPointByVersion), so the library does not link
//   libcuda; they are __grid_constant__ parameters. A box is a column part
//   of the head dim: 64 columns (128-byte rows, 128-byte swizzle; two
//   boxes at hd 128, whose 256-byte rows are wider than the swizzle span),
//   all of hd 32 or 16 (64- and 32-byte swizzle), at hd 80 a 64-column
//   part plus a 16-column one (32-byte swizzle), at hd 112 64 + 32 + 16
//   columns (128-, 64- and 32-byte swizzle, one tensor map per width), and
//   three 64-column parts at hd 192. Rows past Sq or Skv come as zeros.
//   S = Q K^T: wgmma.m64n128k16 (m64n64k16 above hd 128) with Q and K
//   read from shared memory through matrix descriptors (K-major, the
//   swizzle the boxes were written with; a k16 step inside a row advances
//   the start address by 32 bytes).
//   O += P V: wgmma with P from registers as the A operand (the S
//   accumulator packed to bf16: the accumulator layout of two n8 blocks is
//   the A layout of one k16 step) and V as B from shared memory, MN-major
//   (transposed), N = hd: one m64n128k16 over both 64-column parts at hd
//   128 (the part stride is the leading byte offset), n64 + n16 at hd 80,
//   n64 + n32 + n16 at hd 112, one m64n192k16 over three parts at hd 192.
//   Schedule: S(t) and P(t-1) V(t-1) are started together and the online
//   softmax of S(t) runs while P V is in flight; the two consumers take
//   turns to start them (named barriers), so one's softmax runs beside the
//   other's products.
//   Registers and shared memory: the kernel starts at 168 registers a
//   thread (three warps on each of the SM's four register-file quarters);
//   the consumers' setmaxnreg.inc 240 lets ptxas give their code more (it
//   reaches about 184: S 64 + O hd / 2 + P 32 live at once, no spills;
//   phase 2 of chip_smoke.py prints the report). The mbarrier wait has no
//   trap on a timeout: with one, ptxas held the consumers to about 175
//   registers, spilled 200 bytes and waited on every wgmma. Shared memory
//   at hd 128: Q 32 KB and three stages of K and V of 32 KB each, 224 KB
//   and 1 KB of alignment: one block of 12 warps per SM, whose latency the
//   ring and the schedule hide instead of more blocks. Above hd 128 the kv
//   tile is 64 rows (kv_rows; S is m64n64k16): at hd 192, Q 48 KB and
//   three stages of K and V of 24 KB each, 192 KB; at hd 112 (128-row
//   tiles), Q 28 KB and three stages of K and V of 28 KB each, 196 KB.
//   What it does about the causes that held the earlier designs back: K/V
//   copies are asynchronous and a tile ahead of the products (three
//   stages: V(t-1) for P V, K(t) for S, tile t + 1 in flight); S, P and the rescale factors never touch shared memory; the
//   products run on wgmma instead of mma.sync, Q is read by the tensor
//   cores from shared memory and never staged through registers; P's
//   rounding to bf16 is the one rounding the plain version does not make.
//   Built with fused multiply-add (build.py gives this kernel alone no
//   -fmad=false): p = 2^(s * scale * log2 e - m'), one FMA and one
//   ex2.approx.ftz an element.
//
// float32 (the card-vs-CPU checks): the same walk on the CUDA cores, a
//   thread pair per row, through shared memory, so no TF32 rounding enters.
//   Shared memory is Q, K and V tiles of 64 rows of hd + 4 floats and P:
//   164 KB at hd 192.
//
// Plain C entry point flash_attention_launch: launches on the given stream,
// does not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// kv tiles of BKV rows that a block of BQ query rows from q0 has to visit
template <int BQ, int BKV>
__device__ __forceinline__ int visible_tiles(const Args& a, int q0) {
  const int all = cdiv(a.Skv, BKV);
  if (!a.causal) return all;
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  return min(all, q_last / BKV + 1);
}

// ---------------------------------------------------------------- bf16 --

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
// kv rows per tile: 128 (S is m64n128), but 64 above head dim 128 (S is
// m64n64): three stages of 128-row K and V tiles at hd 192 would need 288
// KB beside Q's 48, over the 227 KB a block may have; 64-row tiles need
// 144 KB, and keep the consumers' live registers (S 32 + O 96 + P 16) below
// hd 128's (64 + 64 + 32)
template <int HD>
__host__ __device__ constexpr int kv_rows() {
  return HD > 128 ? 64 : 128;
}
constexpr int kStages = 3;      // K/V ring
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 produces
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

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

// shared memory (bytes from a 1024-aligned base): Q, the K and V rings,
// then the barriers (full and empty per stage, and Q's)
template <int HD>
struct Smem {
  static constexpr int kTile = kv_rows<HD>() * HD * 2;   // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * HD * 2;  // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kFull = kV + kStages * kTile;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kQFull = kEmpty + 8 * kStages;
  static constexpr int kBytes = kQFull + 8 + 1024;  // + alignment slack
};

// one tensor map per part width (Parts::map): [0] for the leading parts,
// [1] and [2] for the tail parts (HD = 80: [1] of 16 columns; HD = 112:
// [1] of 32, [2] of 16)
struct Maps {
  CUtensorMap q[3], k[3], v[3];
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

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

// wait for the phase of parity `parity` to complete (no timeout: a trap
// on this path costs the consumers their registers, see the note above)
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

// S (+)= A B^T for one m64n128k16 step, A and B K-major in shared memory
// (descriptors); scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
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

// O += P V for P's k16 step kk (pa), V (MN-major, its rows are kv) from
// the tile at v_s: the leading parts as one wgmma of kN0 * kW0 columns,
// the part stride as its leading byte offset; each tail part as one of its
// width (one swizzle atom wide, so its leading byte offset is unused)
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&pa)[4], uint32_t v_s,
                                        int kk) {
  using P = Parts<HD>;
  constexpr int kBKV = kv_rows<HD>();
  constexpr int rb = 2 * P::kW0;
  wgmma_rs<P::kN0 * P::kW0>(
      o, pa, make_desc(v_s + 16 * kk * rb, kBKV * rb, 8 * rb, rb));
  auto tail = [&](int p) {
    const int tb = 2 * P::width(p);
    return make_desc(v_s + kBKV * 2 * P::col(p) + 16 * kk * tb, 16, 8 * tb,
                     tb);
  };
  if constexpr (P::kT32 > 0)
    wgmma_rs<32>(o + P::col(P::kN0) / 2, pa, tail(P::kN0));
  if constexpr (P::kT16 > 0)
    wgmma_rs<16>(o + P::col(P::kCount - 1) / 2, pa, tail(P::kCount - 1));
}

// all of P's k16 steps (KK = the tile's rows / 16) for tile v_s
template <int HD, int KK>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const uint32_t (&pa)[KK][4],
                                        uint32_t v_s) {
  static_assert(KK == kv_rows<HD>() / 16, "P is not one kv tile");
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) pv_step<HD>(o, pa[kk], v_s, kk);
}

// S = Q K^T for consumer c's 64 rows of the Q tile at q_s: k16 steps over
// the head dim, part by part; a k16 step inside a swizzled row advances the
// start address by 32 bytes
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[kv_rows<HD>() / 2],
                                        uint32_t q_s, int c, uint32_t k_s) {
  using P = Parts<HD>;
  constexpr int kBKV = kv_rows<HD>();
#pragma unroll
  for (int p = 0; p < P::kCount; ++p) {
    const int rb = 2 * P::width(p);
    const uint32_t q_p = q_s + kBQ * 2 * P::col(p) + 64 * c * rb;
    const uint32_t k_p = k_s + kBKV * 2 * P::col(p);
#pragma unroll
    for (int st = 0; st < P::width(p) / 16; ++st)
      wgmma_ss<kBKV>(s, make_desc(q_p + 32 * st, 16, 8 * rb, rb),
                     make_desc(k_p + 32 * st, 16, 8 * rb, rb), p + st);
  }
}

// 2^x, flushing results below 2^-126 to zero (a probability that small
// adds nothing at float32 precision)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumers take turns to start their products (named barriers 1 and
// 2, 256 threads each), so that one's softmax runs beside the other's
// products on the tensor cores
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// Online softmax of a tile's scores for the lane's two rows (bit 1 of i
// picks the row): scores past Skv and, causally, past the row masked;
// updates the running max m (raw score units) and the lane's partial sums
// l, leaves p in s and the factor O is to be rescaled by in corr. Every
// row sees kv position 0 in tile 0, so m is finite from the first tile on
// and a masked score of -inf gives p = 0.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2],
                                               const Args& a, int kv0,
                                               int q_lo, int row0, int t4,
                                               float cl) {
  constexpr int kBKV = 2 * N;   // the tile's kv rows
  if (kv0 + kBKV > a.Skv || (a.causal && kv0 + kBKV - 1 > q_lo)) {
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      const int kv_pos = kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int q_pos = row0 + 8 * ((i >> 1) & 1);
      if (kv_pos >= a.Skv || (a.causal && kv_pos > q_pos)) s[i] = neg_inf();
    }
  }
  float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[r] = exp2_ftz((m[r] - mx) * cl);
    m[r] = mx;
    mc[r] = mx * cl;
  }
#pragma unroll
  for (int i = 0; i < kBKV / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_ftz(fmaf(s[i], cl, -mc[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// P to bf16 A fragments: k16 step kk is S's n8 blocks 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ Maps maps, Args a) {
  using P = Parts<HD>;
  using L = Smem<HD>;
  constexpr int kBKV = kv_rows<HD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + L::kFull, bar_empty = base + L::kEmpty;
  const uint32_t bar_q = base + L::kQFull;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int n_tiles = visible_tiles<kBQ, kBKV>(a, q0);
  // warpgroup index, warp-uniform to the compiler: each role's branch and
  // its setmaxnreg are taken by whole warpgroups
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);                 // the producer
      mbar_init(bar_empty + 8 * st, 4 * kConsumers);   // each consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kBQ * HD * 2);
#pragma unroll
      for (int p = 0; p < P::kCount; ++p)
        tma_load(base + L::kQ + kBQ * 2 * P::col(p), &maps.q[P::map(p)],
                 bar_q, P::col(p), h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kStages;
        if (t >= kStages)   // the consumers released the stage's last tile
          mbar_wait(bar_empty + 8 * stage, (t / kStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * stage, 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) {
          const int m = P::map(p);
          const uint32_t off = stage * L::kTile + kBKV * 2 * P::col(p);
          tma_load(base + L::kK + off, &maps.k[m], bar_full + 8 * stage,
                   P::col(p), hk, t * kBKV, b);
          tma_load(base + L::kV + off, &maps.v[m], bar_full + 8 * stage,
                   P::col(p), hk, t * kBKV, b);
        }
      }
    }
    return;
  }

  // consumer c: query rows [64c, 64c + 64) of the block, 16 per warp
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_lo = q0 + 64 * c;
  const int row0 = q_lo + 16 * ((threadIdx.x >> 5) & 3) + g;  // and row0 + 8
  const float cl = a.scale * kLog2e;
  const uint32_t q_s = base + L::kQ;
  auto k_tile = [&](int st) { return base + L::kK + st * L::kTile; };
  auto v_tile = [&](int st) { return base + L::kV + st * L::kTile; };
  auto release = [&](int st) {          // this warp is done with stage st
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  };

  float o[HD / 2];       // n8 block j of O: o[4j .. 4j + 3]
  float s[kBKV / 2];     // n8 block j of S: s[4j .. 4j + 3]
  uint32_t pa[kBKV / 16][4];   // P(t - 1) as bf16 A fragments
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  if (c == 1) turn_pass(c);   // consumer 0 takes the first turn

  // tile 0: S(0) and its softmax
  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  turn_wait(c);
  wgmma_fence();
  qk_tile<HD>(s, q_s, c, k_tile(0));
  wgmma_commit();
  turn_pass(c);
  wgmma_wait0();
  fence_regs(s);
  online_softmax(s, m, l, corr, a, 0, q_lo, row0, t4, cl);
  pack_p(pa, s);

  // tile t: S(t) and P(t-1) V(t-1) in flight together; the softmax of
  // S(t) runs while P V still does
  for (int t = 1; t < n_tiles; ++t) {
    const int stage = t % kStages;  // the ring stage tile t arrives in
    const int prev = (t - 1) % kStages;
    mbar_wait(bar_full + 8 * stage, (t / kStages) & 1);
    const int buf = stage;  // the ring stage S(t) reads
    turn_wait(c);
    wgmma_fence();
    qk_tile<HD>(s, q_s, c, k_tile(buf));
    wgmma_commit();
    rescale(o, corr);        // to the running max of tile t - 1
    fence_regs(o);
    wgmma_fence();
    pv_tile<HD>(o, pa, v_tile(prev));  // O += P(t-1) V(t-1)
    wgmma_commit();
    turn_pass(c);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(s);
    online_softmax(s, m, l, corr, a, t * kBKV, q_lo, row0, t4, cl);
    wgmma_wait0();
    fence_regs(o);
    release(prev);           // K(t-1) and V(t-1) consumed
    pack_p(pa, s);
  }

  // the last tile's P V
  const int last = (n_tiles - 1) % kStages;
  turn_wait(c);
  rescale(o, corr);
  fence_regs(o);
  wgmma_fence();
  pv_tile<HD>(o, pa, v_tile(last));
  wgmma_commit();
  if (c == 0) turn_pass(c);   // every pass is waited for
  wgmma_wait0();
  fence_regs(o);
  release(last);

  // out = O / max(l, 1e-30), the quad's partial sums first
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  auto* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row0 + 8 * r;
    if (q_pos < a.Sq) {
      __nv_bfloat16* dst =
          out + ((static_cast<long long>(b) * a.Sq + q_pos) * a.Hq + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r],
                                  o[4 * j + 2 * r + 1] * inv[r]);
    }
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

template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using P = Parts<HD>;
  constexpr int kBKV = kv_rows<HD>();
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps;
  const int n_maps = 1 + P::kCount - P::kN0;
  for (int m = 0; m < n_maps; ++m) {
    const int width = P::width(m == 0 ? 0 : P::kN0 + m - 1);
    if (!encode(fn, &maps.q[m], a.q, HD, a.Hq, a.Sq, a.B, width, kBQ) ||
        !encode(fn, &maps.k[m], a.k, HD, a.Hkv, a.Skv, a.B, width, kBKV) ||
        !encode(fn, &maps.v[m], a.v, HD, a.Hkv, a.Skv, a.B, width, kBKV))
      return cudaErrorInvalidValue;
  }
  for (int m = n_maps; m < 3; ++m)   // unused: never read by a copy
    maps.q[m] = maps.k[m] = maps.v[m] = maps.q[0];
  const int smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Sq, kBQ), a.Hq, a.B);
  flash_fwd_bf16<HD><<<grid, kThreads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --

constexpr int kF32BQ = 64;    // query rows per block, a thread pair each
constexpr int kF32BKV = 64;   // kv rows per tile
constexpr int kF32Threads = 2 * kF32BQ;
constexpr int kCols = kF32BKV / 2;  // score columns per thread
constexpr float kNegInf = -1e30f;

// rows [s0, s0 + 64) of head h of batch b of a (B, S, H, HD) float32 tensor
// into shared memory with row stride LD elements, zeros past row S - 1.
// 16-byte loads; HD * 4 is a multiple of 16.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int s0, int S, int H, int h) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < kF32BKV * kPerRow; i += kF32Threads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
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

template <int HD>
struct F32Smem {
  static constexpr int kLd = HD + 4;      // f32 elements (16-byte pad)
  static constexpr int kLdP = kF32BKV + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kF32BQ * kLd * 4;
  static constexpr int kV = kK + kF32BKV * kLd * 4;
  static constexpr int kP = kV + kF32BKV * kLd * 4;
  static constexpr int kBytes = kP + kF32BQ * kLdP * 4;
};

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(Args a) {
  using L = F32Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Qs = reinterpret_cast<float*>(smem + L::kQ);
  auto* Ks = reinterpret_cast<float*>(smem + L::kK);
  auto* Vs = reinterpret_cast<float*>(smem + L::kV);
  auto* Ps = reinterpret_cast<float*>(smem + L::kP);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int q_pos = q0 + row;
  const float qk_scale = a.scale * kLog2e;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);

  load_tile<HD, L::kLd>(Qs, q, b, q0, a.Sq, a.Hq, h);

  float o[HD / 2];  // columns 2j + half of this row
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = visible_tiles<kF32BQ, kF32BKV>(a, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kF32BKV;
    __syncthreads();
    load_tile<HD, L::kLd>(Ks, k, b, kv0, a.Skv, a.Hkv, hk);
    load_tile<HD, L::kLd>(Vs, v, b, kv0, a.Skv, a.Hkv, hk);
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
    for (int c = 0; c < kF32BKV; ++c) {
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

template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = F32Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Sq, kF32BQ), a.Hq, a.B);
  flash_fwd_f32<HD><<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<HD>(a, stream);
  if (dtype == 1) return launch_bf16<HD>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 is float32, 1 is bfloat16. q (B, Sq, Hq, hd), k and v
// (B, Skv, Hkv, hd), o like q, all contiguous and 16-byte aligned;
// Hq % Hkv == 0. The head dims below are exactly
// flash_attention.HEAD_DIMS; a CPU test checks it. Each is a multiple of
// 16 (whole k16 steps, 16-byte row copies); 80 is zamba2's shared block,
// 112 kimi-k2's attention, 192 MLA's prefill (deepseek-v2-lite: 128 + 64
// columns of q and k, v padded to 192).
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
  else if (hd == 112) err = launch_hd<112>(a, dtype, s);
  else if (hd == 128) err = launch_hd<128>(a, dtype, s);
  else if (hd == 192) err = launch_hd<192>(a, dtype, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
