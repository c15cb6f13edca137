// The GTF weight gradients in float32 for Hopper (sm_90a): the two routes
// that the launch plan (ops/cuda/bfvi_scan.py: f32_wgrad_plan) gives every
// float32 backward scan's weight-gradient launch, chosen by shape:
//   gtf_wgrad_narrow_kernel   "narrow"   (D, H up to 32, few outputs)
//   gtf_wgrad_wgmma_kernel    "wgmma"    (every other shape)
// built by f32_wgrad.cu, with the C entry points gtf_wgrad_narrow and
// gtf_wgrad_wgmma. bfvi_scan.cuh's gtf_wgrad_kernel (the tile engine of
// tf32x3.cuh, mma.sync) stays as the route "tiled", which the plan gives no shape: the
// twin that these routes are timed against.
//
// Replaces the weight-gradient products of the Pallas TPU kernel
// multimodal_dmm_tpu/ops/pallas/bfvi_scan.py: _bwd_kernel (:451-470). Over
// the R = (T-1) K B particle rows r that the float32 backward scan writes
// (zs: the first R rows of z_traj; xs = [h1 | hn | z_nonlin]; ys = [d_a1 |
// d_b1 | d_zlin | d_a2 | d_znonlin | d_sraw]), in float32:
//   dW1 = sum_r z^T [d_a1 | d_b1 | d_zlin]    dWg2 = sum_r h1^T d_a2
//   dWn2 = sum_r hn^T d_znonlin               dWs  = sum_r z_nonlin^T d_sraw
// and each bias gradient as the column sum of its cotangent block. Both
// routes write `splits` partials laid out as bfvi_scan.cuh's gtf_wgrad
// writes them ([dW1 (D x la) | db1 | dWg2 (H x D) | dbg2 | dWn2 (H x D) |
// dbn2 | dWs (D x D) | dbs], dW in (in, out) layout, la = 2H + D), every
// float of a partial written by one CTA; the wrapper sums the partials in
// a fixed order. No atomics: two runs agree bit for bit.
//
// Route "narrow" (the spirals model: D = 5 run as 8, H = 20). The four
// products and the bias sums are 840 outputs, 768 multiply-adds a row,
// against the row's 512 bytes: bytes bound the launch (0.11 ms at the K =
// 25 launch's 742,500 rows, 3.35 TB/s), and the tile engine's 128 x 64
// tiles were mostly padding. A CTA walks a contiguous range of rows in
// stages: one thread copies each stage's rows of zs, xs and ys, each one
// contiguous block, by 1-D TMA (cp.async.bulk) into a ring of three stages
// in shared memory. Each thread owns one 4 x 4 block of one product's
// outputs (or four bias sums) and accumulates it with f32 FMA (the tensor
// cores give nothing at 8- to 48-wide outputs, and f32 FMA is at least as
// exact as 3xTF32). The CTA's threads are `groups` copies of its blocks:
// group g takes rows g, g + groups, ... of every stage, in row order, and at
// the end the groups' sums are added in group order. Where the blocks
// outnumber a CTA's threads (wide widths, the route when named) they are
// cut into `chunks`, a CTA each, every CTA reading whole rows.
//
// Route "wgmma" (Weizmann and VidTIMIT, D = H = 256: 47 GFLOP at the K = 25
// launch, 0.29 ms in three TF32 passes at 495 TFLOP/s; the tile engine's
// mma.sync ran at about 120 TFLOP/s). wgrad_bf16.cuh's structure in 3xTF32:
//   - each output is cut into tiles of 64 rows (wgmma's M) of the
//     product's out side (the cotangent columns, the A operand) by up to
//     128 columns of its in side (BN = 32, 64 or 128, the B operand); a
//     unit is two tiles of one product that share their columns, one a
//     warpgroup, and the grid is the units times the row ranges ("splits")
//     that fill the SMs' waves as evenly as the rows allow (at most two
//     waves), one CTA an SM;
//   - a ring of four 32-row stages in flight, each the 32-column boxes of
//     the unit's A and B columns by TMA (cp.async.bulk.tensor, 128-byte
//     swizzle), completed on mbarriers. Thread 0 refills a slot as soon as
//     both warpgroups have read it: a producer warp would be a ninth warp,
//     and nine warps of the consumers' 190-odd registers do not fit the
//     SM's four register files of 16,384 (three warps on one of them);
//   - TF32 wgmma reads both operands K-major only, and the rows (the
//     reduction) arrive MN-major, so every stage is converted: the two
//     warpgroups read the f32 B boxes and write their hi and lo TF32 images
//     K-major in the 128-byte swizzle that wgmma reads (double-buffered, so
//     that a stage's conversion runs under the previous stage's products),
//     and each thread loads its A fragment from the f32 boxes with
//     ld.shared and splits it in registers (tf32x3.cuh's split: hi =
//     tf32(x), lo = tf32(x - hi)). Depth j of a stage's wgmma step i sits
//     at row 8 i + 2 (j % 4) + j / 4 of the stage, so that both reads are
//     free of bank conflicts;
//   - each stage runs wgmma.mma_async m64nBNk8 in three passes (lo*hi +
//     hi*lo + hi*hi) into a fresh accumulator, which is then added to the
//     running f32 sum with ordinary rounded adds (the tensor cores' own
//     adds truncate, which over thousands of rows would bias a sum): the
//     promotion of tf32x3.cuh's LargePromoted and of wgrad_bf16.cuh;
//   - the bias sums come from the A fragments (the cotangents) of the
//     units at the first column tile, summed in f32 as they are loaded.
// Ragged edges need no code: TMA fills rows past R and columns past a
// tensor with zeros, and the store skips outputs past the product's.
//
// D and H must be multiples of 4 (the wrapper zero-pads).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace f32wgrad {

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Waits, with every thread of the warp, for phase `parity` of the mbarrier
// at `bar` (the loop's exit is a warp vote, so the compiler sees it as
// uniform); a wait still open after 10 s traps, so a fault ends the launch
// with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const unsigned long long t0 = now_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (__all_sync(0xffffffffu, done)) return;
    if (__any_sync(0xffffffffu, now_ns() - t0 > 10000000000ull)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// A 1-D TMA copy of `bytes` (a multiple of 16) from global memory into this
// CTA's shared memory, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One 32-row box of 32 floats of a row tensor (columns col.., rows row..)
// into shared memory at dst, in the 128-byte swizzle, completed on the
// mbarrier at bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(bar) : "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding of every finite x (ops/cuda's
// tf32_round), in two integer instructions where ptxas emulates the cvt in
// five; the split's cost is a large part of a stage's (PERF.md).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1,024 bytes apart (the image's base is 1,024-aligned).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers that an asynchronous wgmma reads or writes, kept live and in
// place up to this point (the compiler does not see the wgmma's use).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// wgmma.mma_async m64nNk8, TF32 x TF32 -> f32: A from registers (the
// m16n8k8 fragment of each warp's 16 rows: a[0] (g, q), a[1] (g + 8, q),
// a[2] (g, q + 4), a[3] (g + 8, q + 4), g = lane / 4, q = lane % 4), B from
// shared memory (descriptor); `acc` 0 starts the sum (d = A B).
template <int N>
struct Mma;
template <>
struct Mma<32> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4],
                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Mma<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4],
                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Mma<128> {
  __device__ static void run(float (&d)[64], const uint32_t (&a)[4],
                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// ---------------------------------------------------------------------------
// The partial's layout
// ---------------------------------------------------------------------------

// Offsets of each gradient in a partial of P floats (bfvi_scan.cuh's
// gtf_wgrad, ops/cuda/bfvi_scan.py: partial_size and unpack_partial).
struct Layout {
  long long dw1, db1, dwg2, dbg2, dwn2, dbn2, dws, dbs, P;
};

__host__ __device__ inline Layout layout(int D, int H) {
  const long long la = 2LL * H + D;
  Layout o;
  o.dw1 = 0;
  o.db1 = D * la;
  o.dwg2 = o.db1 + la;
  o.dbg2 = o.dwg2 + (long long)H * D;
  o.dwn2 = o.dbg2 + D;
  o.dbn2 = o.dwn2 + (long long)H * D;
  o.dws = o.dbn2 + D;
  o.dbs = o.dws + (long long)D * D;
  o.P = o.dbs + D;
  return o;
}

// ---------------------------------------------------------------------------
// Route "narrow"
// ---------------------------------------------------------------------------

constexpr int kNarrowThreads = 512;  // the most a CTA (ops/cuda: WGRAD_NARROW_THREADS)
constexpr int kNarrowStages = 3;     // the ring (WGRAD_NARROW_RING)

struct NarrowParams {
  const float *zs, *xs, *ys;
  float* partial;
  int R, D, H;
  int rows;          // rows a stage
  int stages;        // stages over the R rows
  int splits, chunks, per_chunk, groups;
  int slot_floats;   // a ring slot: rows x (D + la + ly)
  long long P;       // floats of a partial
};

// The 4 x 4 blocks of the four products, then the bias sums in blocks of 4
// cotangent columns.
__host__ __device__ inline int narrow_blocks(int D, int H) {
  const int la = 2 * H + D, D4 = D / 4;
  return D4 * (la / 4) + 2 * (H / 4) * D4 + D4 * D4 + (la + 3 * D) / 4;
}

// Block b: its x columns (in the stage's zs rows, x_sec 0, or xs rows, 1;
// -1 for a bias block), its y columns (ys) and where its outputs go: row a
// of the block at out + a ld.
struct NBlock {
  int x_sec, x_col, y_col, ld;
  long long out;
};

__device__ __forceinline__ NBlock narrow_block(int b, int D, int H) {
  const int la = 2 * H + D, D4 = D / 4, H4 = H / 4, L4 = la / 4;
  const Layout o = layout(D, H);
  if (b < D4 * L4) {  // dW1 = z^T [d_a1 | d_b1 | d_zlin]
    const int i = b / L4, j = b % L4;
    return NBlock{0, 4 * i, 4 * j, la, o.dw1 + 4LL * i * la + 4 * j};
  }
  b -= D4 * L4;
  if (b < 2 * H4 * D4) {  // dWg2 = h1^T d_a2, dWn2 = hn^T d_znonlin
    const int p = b / (H4 * D4), c = b % (H4 * D4), i = c / D4, j = c % D4;
    return NBlock{1, p * H + 4 * i, la + p * D + 4 * j, D,
                  (p ? o.dwn2 : o.dwg2) + 4LL * i * D + 4 * j};
  }
  b -= 2 * H4 * D4;
  if (b < D4 * D4) {  // dWs = z_nonlin^T d_sraw
    const int i = b / D4, j = b % D4;
    return NBlock{1, 2 * H + 4 * i, la + 2 * D + 4 * j, D,
                  o.dws + 4LL * i * D + 4 * j};
  }
  const int c = 4 * (b - D4 * D4);  // bias sums of ys columns c .. c + 3
  const long long out = c < la ? o.db1 + c
                        : c < la + D ? o.dbg2 + (c - la)
                        : c < la + 2 * D ? o.dbn2 + (c - la - D)
                                         : o.dbs + (c - la - 2 * D);
  return NBlock{-1, 0, c, 0, out};
}

}  // namespace f32wgrad

// One CTA: chunk blockIdx.x % chunks of the blocks over the row stages of
// split blockIdx.x / chunks.
__global__ void __launch_bounds__(f32wgrad::kNarrowThreads, 2)
    gtf_wgrad_narrow_kernel(const __grid_constant__ f32wgrad::NarrowParams p) {
  using namespace f32wgrad;
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) unsigned long long full[kNarrowStages];
  const int D = p.D, la = 2 * p.H + D, ly = la + 3 * D;
  const int chunk = blockIdx.x % p.chunks, split = blockIdx.x / p.chunks;
  const int s0 = (int)((long long)split * p.stages / p.splits);
  const int n_st = (int)((long long)(split + 1) * p.stages / p.splits) - s0;
  const int grp = threadIdx.x / p.per_chunk, slot = threadIdx.x % p.per_chunk;
  const int blk = chunk * p.per_chunk + slot;
  const bool active = grp < p.groups && blk < narrow_blocks(D, p.H);
  const NBlock nb = narrow_block(active ? blk : 0, D, p.H);
  const uint32_t bar0 = smem_u32(full);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kNarrowStages; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage i's rows of zs, xs and ys, each one contiguous block, into ring
  // slot i % kNarrowStages (zs rows, then xs rows, then ys rows).
  auto issue = [&](int i) {
    const int row0 = (s0 + i) * p.rows, n = min(p.rows, p.R - row0);
    const uint32_t bar = bar0 + 8 * (i % kNarrowStages);
    const uint32_t dst =
        smem_u32(sm + (size_t)(i % kNarrowStages) * p.slot_floats);
    mbar_expect(bar, n * (D + la + ly) * 4);
    bulk_copy(dst, p.zs + (size_t)row0 * D, n * D * 4, bar);
    bulk_copy(dst + 4 * p.rows * D, p.xs + (size_t)row0 * la, n * la * 4,
              bar);
    bulk_copy(dst + 4 * p.rows * (D + la), p.ys + (size_t)row0 * ly,
              n * ly * 4, bar);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kNarrowStages - 1 && i < n_st; ++i) issue(i);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  const int x_ld = nb.x_sec == 0 ? D : la;
  for (int i = 0; i < n_st; ++i) {
    // The slot of stage i - 1 is read (the __syncthreads below): refill it.
    if (threadIdx.x == 0 && i + kNarrowStages - 1 < n_st)
      issue(i + kNarrowStages - 1);
    mbar_wait(bar0 + 8 * (i % kNarrowStages), (i / kNarrowStages) & 1);
    const float* base = sm + (size_t)(i % kNarrowStages) * p.slot_floats;
    const int n = min(p.rows, p.R - (s0 + i) * p.rows);
    const float* y = base + p.rows * (D + la) + nb.y_col;
    const float* x = base + (nb.x_sec == 0 ? 0 : p.rows * D) + nb.x_col;
    if (active && nb.x_sec < 0) {
      for (int r = grp; r < n; r += p.groups) {
        const float4 v = *reinterpret_cast<const float4*>(y + (size_t)r * ly);
        acc[0][0] += v.x;
        acc[0][1] += v.y;
        acc[0][2] += v.z;
        acc[0][3] += v.w;
      }
    } else if (active) {
      for (int r = grp; r < n; r += p.groups) {
        const float4 v = *reinterpret_cast<const float4*>(y + (size_t)r * ly);
        const float4 u =
            *reinterpret_cast<const float4*>(x + (size_t)r * x_ld);
        const float xv[4] = {u.x, u.y, u.z, u.w}, yv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xv[a], yv[c], acc[a][c]);
      }
    }
    __syncthreads();
  }

  // The groups' sums, added in group order by group 0; the ring is free.
  float* red = sm;
  const int nt = blockDim.x;
#pragma unroll
  for (int e = 0; e < 16; ++e) red[e * nt + threadIdx.x] = acc[e / 4][e % 4];
  __syncthreads();
  if (!active || grp != 0) return;
  float s[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = red[e * nt + slot];
  for (int g = 1; g < p.groups; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] += red[e * nt + g * p.per_chunk + slot];
  float* out = p.partial + (size_t)split * p.P + nb.out;
  if (nb.x_sec < 0) {
    *reinterpret_cast<float4*>(out) = make_float4(s[0], s[1], s[2], s[3]);
    return;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(out + (size_t)a * nb.ld) =
        make_float4(s[4 * a], s[4 * a + 1], s[4 * a + 2], s[4 * a + 3]);
}

// ---------------------------------------------------------------------------
// Route "wgmma"
// ---------------------------------------------------------------------------

namespace f32wgrad {

constexpr int kWgRows = 32;           // rows a stage: one 32-deep TF32 slab
constexpr int kBox = kWgRows * 128;   // a box: 32 rows of 32 floats, 4 KB
constexpr int kWgStages = 4;          // the ring (WGRAD_WGMMA_RING)
constexpr int kStageBytes = 8 * kBox; // A: two boxes a warpgroup; B: up to 4
constexpr int kImgBytes = 128 * 128;  // a B image half: BN rows of 128 bytes
// The ring, two B images (hi and lo) and the alignment of the ring to 1 KB
// (WGRAD_WGMMA_SMEM): 197,632 bytes, one CTA an SM.
constexpr int kWgSmem = kWgStages * kStageBytes + 4 * kImgBytes + 1024;
// Two warpgroups, no producer warp: a CTA of 9 warps could hold at most 168
// registers a thread (three warps on one of the SM's four register files
// of 16,384), where these take about 190; thread 0 issues the loads.
constexpr int kWgThreads = 2 * 128;
constexpr int kUnitRows = 128;        // a unit's A rows: 64 a warpgroup

// One product: dW (out) = sum over rows of A^T B, A the ys columns a_col ..
// a_col + M (the gradient's out side), B the columns b_col .. b_col + N of
// zs (b_map 0) or xs (1) (its in side); output (n, m) at out + n M + m of a
// partial (the (in, out) layout), the bias sum of A's column m at bias + m.
// Tiles of bn (32, 64 or 128) B columns.
struct WJob {
  int a_col, b_map, b_col, M, N, bn;
  long long out, bias;
};

struct WgParams {
  CUtensorMap ys, xs, zs;
  WJob jobs[4];
  int units, splits, stages;
  long long P;
  float* partial;
};

__host__ __device__ inline int job_units(const WJob& j) {
  return ((j.M + kUnitRows - 1) / kUnitRows) * ((j.N + j.bn - 1) / j.bn);
}


// The B boxes of a stage (f32, rows the depth, 32 columns a box, 128-byte
// swizzle) as the hi and lo TF32 images of BN rows, K-major in the 128-byte
// swizzle that wgmma reads: image row n holds the stage's 32 rows of
// column n, logical position L = 8 i + p (wgmma step i, its column p) the
// stage's row 8 i + 2 (p % 4) + p / 4; 16-byte chunk c of row n at c ^ (n %
// 8). Thread t of the two warpgroups writes chunks (n, c) = (idx % BN, idx
// / BN), idx = t + 256 u: a warp reads one row of 32 consecutive columns
// and writes 8-row groups whole, both without bank conflicts.
template <int BN>
__device__ __forceinline__ void convert(uint32_t bbox, uint32_t img, int t) {
#pragma unroll 2
  for (int u = 0; u < BN / 32; ++u) {
    const int idx = t + 256 * u, n = idx % BN, c = idx / BN;
    const uint32_t box = bbox + (n >> 5) * kBox;
    const int nn = n & 31;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * (c >> 1) + 2 * e + (c & 1);
      const float v = lds(box + row * 128 + ((((nn >> 2) ^ (row & 7)) << 4) |
                                             ((nn & 3) << 2)));
      h[e] = tf32_bits(v);
      l[e] = tf32_bits(v - __uint_as_float(h[e]));
    }
    const uint32_t off = n * 128 + ((c ^ (n & 7)) << 4);
    sts4(img + off, h);
    sts4(img + kImgBytes + off, l);
  }
}

// A consumer warpgroup's tile: rows m0 .. m0 + 63 of the job's A (its two
// boxes at a_box of each stage) by the unit's BN columns, summed over the
// CTA's stages, then stored to its split's partial; `bias`: the unit at the
// first column tile, which also sums A's columns. Both warpgroups convert
// every stage's B boxes and run every stage's products, also a warpgroup
// whose rows all lie past the job's M (a unit's second tile at the edge:
// its products are not stored), so that every wgmma runs on a path that
// the compiler sees as uniform (a divergent one serializes the chain).
template <int BN>
__device__ __forceinline__ void consume(const WgParams& p, const WJob& jb,
                                        int m_unit, int n0, int s0, int n_st,
                                        int split, uint32_t ring, uint32_t img,
                                        uint32_t full) {
  const int t = threadIdx.x, wg = t >> 7, w = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = m_unit + 64 * wg;  // this warpgroup's first row of A
  const bool bias = n0 == 0;
  // Stage i of the CTA's rows into ring slot i % kWgStages (thread 0): the
  // unit's four A boxes (both warpgroups' 64 columns) and BN / 32 B boxes.
  auto issue = [&](int i) {
    const uint32_t bar = full + 8 * (i % kWgStages);
    const uint32_t st = ring + (i % kWgStages) * kStageBytes;
    const int row = (s0 + i) * kWgRows;
    const CUtensorMap* bmap = jb.b_map ? &p.xs : &p.zs;
    mbar_expect(bar, (4 + BN / 32) * kBox);
    for (int b = 0; b < 4; ++b)
      tma_box(st + b * kBox, &p.ys, jb.a_col + m_unit + 32 * b, row, bar);
    for (int b = 0; b < BN / 32; ++b)
      tma_box(st + (4 + b) * kBox, bmap, jb.b_col + n0 + 32 * b, row, bar);
  };
  if (t == 0)
    for (int i = 0; i < kWgStages && i < n_st; ++i) issue(i);
  float tot[BN / 2], acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) tot[i] = acc[i] = 0.f;
  float bsum[2] = {0.f, 0.f};
  uint32_t hi[4][4], lo[4][4];
  // This thread's A rows 16 w + g and + 8 of the warpgroup's 64: box w / 2
  // of the two, columns mm0 and mm0 + 8 of its 32.
  const uint32_t a_box = (2 * wg + (w >> 1)) * kBox;
  const int mm0 = 16 * (w & 1) + g;
  auto a_at = [&](uint32_t st, int row, int mm) {
    return lds(st + a_box + row * 128 +
               ((((mm >> 2) ^ (row & 7)) << 4) | ((mm & 3) << 2)));
  };
  for (int i = 0; i < n_st; ++i) {
    const int slot = i % kWgStages;
    mbar_wait(full + 8 * slot, (i / kWgStages) & 1);
    const uint32_t st = ring + slot * kStageBytes;
    const uint32_t ib = img + (i & 1) * 2 * kImgBytes;  // hi, then lo
    // Under the products of stage i - 1, which read the other image.
    convert<BN>(st + 4 * kBox, ib, t);
    if (i > 0) {  // stage i - 1's products are done: promote them
      wg_wait0();
      fence_acc(acc);
      fence_frag(hi);
      fence_frag(lo);
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) tot[r] += acc[r];
    }
    // Step k: a[0] = A[g][8 k + 2 q], a[1] = A[g + 8][8 k + 2 q], a[2] =
    // A[g][8 k + 2 q + 1], a[3] = A[g + 8][8 k + 2 q + 1] (rows of the
    // stage; the images' order of depth).
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r0 = 8 * k + 2 * q;
      const float x[4] = {a_at(st, r0, mm0), a_at(st, r0, mm0 + 8),
                          a_at(st, r0 + 1, mm0), a_at(st, r0 + 1, mm0 + 8)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[k][e] = tf32_bits(x[e]);
        lo[k][e] = tf32_bits(x[e] - __uint_as_float(hi[k][e]));
      }
      if (bias) {
        bsum[0] += x[0];
        bsum[0] += x[2];
        bsum[1] += x[1];
        bsum[1] += x[3];
      }
    }
    // The image is whole (both warpgroups wrote it) and visible to wgmma;
    // both warpgroups' products of stage i - 1 are done, so the other image
    // is free for stage i + 1; and the slot is read, so thread 0 refills
    // it with stage i + kWgStages.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t == 0 && i + kWgStages < n_st) issue(i + kWgStages);
    fence_acc(acc);
    fence_frag(hi);
    fence_frag(lo);
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Mma<BN>::run(acc, lo[k], desc(ib + 32 * k), k > 0);
      Mma<BN>::run(acc, hi[k], desc(ib + kImgBytes + 32 * k), 1);
      Mma<BN>::run(acc, hi[k], desc(ib + 32 * k), 1);
    }
    wg_commit();
  }
  if (n_st > 0) {
    wg_wait0();
    fence_acc(acc);
    fence_frag(hi);
    fence_frag(lo);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) tot[r] += acc[r];
  }
  // The accumulator layout of m64nNk8: warp w of the warpgroup holds rows
  // 16 w + g (+ 8), columns 8 j + 2 q (+ 1).
  float* part = p.partial + (size_t)split * p.P;
  const int m = m0 + 16 * w + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mh = m + 8 * h, n = n0 + 8 * j + 2 * q + e;
        if (mh < jb.M && n < jb.N)
          part[jb.out + (size_t)n * jb.M + mh] = tot[4 * j + 2 * h + e];
      }
  if (!bias) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // The four lanes of a row hold its columns' sums over rows 2 q, 2 q + 1
    // (mod 8) of each stage: (q0 + q1) + (q2 + q3) in every lane.
    float s = bsum[h];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0 && m + 8 * h < jb.M) part[jb.bias + m + 8 * h] = s;
  }
}

}  // namespace f32wgrad

// One CTA: unit blockIdx.x % units (a product's two 64-row tiles over BN
// columns) over the row stages of split blockIdx.x / units.
__global__ void __launch_bounds__(f32wgrad::kWgThreads, 1)
    gtf_wgrad_wgmma_kernel(const __grid_constant__ f32wgrad::WgParams p) {
  using namespace f32wgrad;
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) unsigned long long bars[kWgStages];
  const uint32_t ring = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t img = ring + kWgStages * kStageBytes;
  const uint32_t full = smem_u32(bars);

  int u = blockIdx.x % p.units, j = 0;
  while (u >= job_units(p.jobs[j])) u -= job_units(p.jobs[j++]);
  const WJob jb = p.jobs[j];
  const int mt = (jb.M + kUnitRows - 1) / kUnitRows;
  const int split = blockIdx.x / p.units;
  const int s0 = (int)((long long)split * p.stages / p.splits);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Values that every thread of a warp holds, so marked for the compiler
  // (a broadcast from lane 0): wgmma chains whose trip counts or branches
  // it cannot prove uniform are serialized.
  const int m_unit = __shfl_sync(0xffffffffu, (u % mt) * kUnitRows, 0);
  const int bn = __shfl_sync(0xffffffffu, jb.bn, 0);
  const int n0 = __shfl_sync(0xffffffffu, (u / mt) * jb.bn, 0);
  const int n_st = __shfl_sync(
      0xffffffffu,
      (int)((long long)(split + 1) * p.stages / p.splits) - s0, 0);
  if (bn == 128)
    consume<128>(p, jb, m_unit, n0, s0, n_st, split, ring, img, full);
  else if (bn == 64)
    consume<64>(p, jb, m_unit, n0, s0, n_st, split, ring, img, full);
  else
    consume<32>(p, jb, m_unit, n0, s0, n_st, split, ring, img, full);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

namespace f32wgrad {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, through the runtime (no link to libcuda).
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The tensor map of `rows` rows of `width` floats: boxes of 32 x 32, the
// 128-byte swizzle, zeros past the edges; 0 on success.
int row_map(CUtensorMap* map, const void* base, int rows, int width) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)width * 4};
  const cuuint32_t box[2] = {32, kWgRows}, one[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(base), dim, stride, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int tile_width(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

// The four products at widths (D, H) (ops/cuda: _wgmma_jobs).
void wg_jobs(WJob* jobs, int D, int H) {
  const int la = 2 * H + D;
  const Layout o = layout(D, H);
  jobs[0] = WJob{0, 0, 0, la, D, tile_width(D), o.dw1, o.db1};
  jobs[1] = WJob{la, 1, 0, D, H, tile_width(H), o.dwg2, o.dbg2};
  jobs[2] = WJob{la + D, 1, H, D, H, tile_width(H), o.dwn2, o.dbn2};
  jobs[3] = WJob{la + 2 * D, 1, 2 * H, D, D, tile_width(D), o.dws, o.dbs};
}

}  // namespace f32wgrad
}  // namespace

extern "C" {

// Route "narrow": the weight gradients of R rows (zs: R x D, xs: R x (2H +
// D), ys: R x (2H + 4D), float32) at widths (D, H), multiples of 4, into
// `splits` partials at `partial`, on the launch plan of f32_wgrad_plan
// (ops/cuda/bfvi_scan.py): `rows` a stage, the blocks in `chunks` of
// `per_chunk`, `groups` copies of a chunk's blocks in `threads` threads,
// `smem` bytes of shared memory.
int gtf_wgrad_narrow(const float* zs, const float* xs, const float* ys,
                     float* partial, int R, int D, int H, int rows,
                     int splits, int chunks, int per_chunk, int groups,
                     int threads, int smem, void* stream) {
  using namespace f32wgrad;
  const int rowf = D + (2 * H + D) + (2 * H + 4 * D);
  const int stages = rows > 0 ? (R + rows - 1) / rows : 0;
  if (D % 4 || H % 4 || R <= 0 || rows <= 0 || threads % 32 ||
      threads > kNarrowThreads || per_chunk * groups > threads ||
      (long long)per_chunk * chunks < narrow_blocks(D, H) || splits < 1 ||
      splits > stages || smem < kNarrowStages * rows * rowf * 4 ||
      smem < threads * 64)
    return (int)cudaErrorInvalidValue;
  NarrowParams p;
  p.zs = zs;
  p.xs = xs;
  p.ys = ys;
  p.partial = partial;
  p.R = R;
  p.D = D;
  p.H = H;
  p.rows = rows;
  p.stages = stages;
  p.splits = splits;
  p.chunks = chunks;
  p.per_chunk = per_chunk;
  p.groups = groups;
  p.slot_floats = rows * rowf;
  p.P = layout(D, H).P;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)gtf_wgrad_narrow_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gtf_wgrad_narrow_kernel<<<chunks * splits, threads, smem,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Route "wgmma": the same products of R rows into `splits` partials; `units`
// is the plan's count of units (f32_wgrad_plan), checked against the
// kernel's.
int gtf_wgrad_wgmma(const float* zs, const float* xs, const float* ys,
                    float* partial, int R, int D, int H, int units,
                    int splits, void* stream) {
  using namespace f32wgrad;
  if (D % 4 || H % 4 || R <= 0) return (int)cudaErrorInvalidValue;
  const int la = 2 * H + D;
  WgParams p;
  wg_jobs(p.jobs, D, H);
  p.units = 0;
  for (const WJob& j : p.jobs) p.units += job_units(j);
  p.stages = (R + kWgRows - 1) / kWgRows;
  p.splits = splits;
  p.P = layout(D, H).P;
  p.partial = partial;
  if (units != p.units || splits < 1 || splits > p.stages)
    return (int)cudaErrorInvalidValue;
  int err = row_map(&p.ys, ys, R, la + 3 * D);
  if (!err) err = row_map(&p.xs, xs, R, la);
  if (!err) err = row_map(&p.zs, zs, R, D);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)gtf_wgrad_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e != cudaSuccess) return (int)e;
  gtf_wgrad_wgmma_kernel<<<p.units * p.splits, kWgThreads, kWgSmem,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
