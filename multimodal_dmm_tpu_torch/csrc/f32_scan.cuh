// The BFVI filtering scan in float32 for Hopper (sm_90a): the two routes
// that the launch plan (ops/cuda/bfvi_scan.py: f32_scan_plan) gives the
// main path's launches, forward and backward:
//   bfvi_scan_fwd_column_kernel, bfvi_scan_bwd_column_kernel   "column"
//   bfvi_scan_fwd_wgmma_kernel,  bfvi_scan_bwd_wgmma_kernel    "wgmma"
// and the bf16 scans' wgmma route (bf16_scan_plan, below), built by
// f32_scan.cu. bfvi_scan.cuh's kernels (the tile engine of tf32x3.cuh,
// mma.sync) stay as the route "tiled", float32 and bf16, which the plans
// give no shape (the reference the new routes are timed against); this
// file reuses that header's elementwise phases, epilogues and jobs.
//
// Replaces the Pallas TPU kernels of multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:
//   bfvi_scan_fwd_*_kernel <- bfvi_scan_pallas / _fwd_kernel (:118)
//   bfvi_scan_bwd_*_kernel <- bfvi_scan_pallas_bwd / _bwd_kernel (:293)
// and computes what bfvi_scan.cuh's kernels compute, in float32: the same
// outputs, and the backward the same xs/ys rows, which gtf_wgrad_kernel
// turns into the weight gradients.
//
// Route "column", for narrow transitions (the spirals model: D = 5 run as
// 8, H = 20). A step's work there is about 0.8 K multiply-adds a particle
// row, so the time of the tiled route is its grid barriers and the round
// trips through L2 between them, not work. Here one CTA of 128 threads owns
// whole batch columns, all K particles of each, for the whole time loop:
//   - the GTF weights and biases sit in its shared memory for the launch
//     (3.4 KB at D = 8, H = 20), and so do its rows' activations (and in
//     the backward the step's xs/ys rows and the z cotangent);
//   - the products are plain float32 FMA chains, one thread an output, k in
//     order (the tensor cores give nothing at these widths, and f32 FMA is
//     at least as exact as 3xTF32);
//   - the elementwise phases give each (b, d) of its columns a group of
//     lanes of one warp that split its K particles and sum them by a
//     butterfly of shuffles (a fixed order: every lane ends with the same
//     bits);
//   - synchronisation is __syncthreads alone: no grid barrier, no
//     cooperative launch; enough CTAs for every column in one wave;
//   - the backward recomputes the transition of its columns for all T - 1
//     steps with the forward's routine (so bit for bit), writing the xs/ys
//     rows, then walks time in reverse inside the CTA.
//
// Route "wgmma", for every shape the column route does not take (Weizmann
// and VidTIMIT: D = H = 256).
// At K = 25 a step is 2,500 particle rows and 2 GFLOP in three dependent
// products, which the tiled route ran on mma.sync with loads and products
// in turn. Here the scan keeps that route's shape (a cooperative grid of
// one CTA a SM that walks the time loop phase by phase, a grid barrier
// between dependent phases: four a step each way, activations in L2, and
// bfvi_scan.cuh's elementwise phases), and its products run as Hopper runs
// them:
//   - wgmma.mma_async m64nNk8 in TF32, three passes (lo*hi + hi*lo + hi*hi
//     into f32 accumulators, tf32x3.cuh's split, about f32's accuracy);
//   - the B operand, the weights, comes as hi/lo TF32 images that the
//     wrapper packs once per autograd call (f32_pack) in the 128-byte
//     swizzle that wgmma reads, one image per product direction (TF32
//     wgmma reads both operands K-major only: the forward's products read
//     W as (out, in), the input-gradient products W^T). A producer warp
//     copies each 32-deep slab of a tile's weight rows, hi and lo, by TMA
//     (cp.async.bulk) into a ring of shared-memory stages, completing on
//     the stage's mbarrier, and runs ahead across tiles and phases (the
//     weights do not change), while two consumer warpgroups run wgmma on
//     the stages that have arrived and free each after its products;
//   - the A operand, the activations, is read by the consumers straight
//     from L2 into registers (written by other CTAs before the last grid
//     barrier, so read with ld.global.cg) and split into hi/lo there: each
//     thread's wgmma fragment takes 8 consecutive floats of a row per slab
//     (two 16-byte loads; four threads read a row's 128 bytes), because the
//     images put the depth of each slab in the matching order (k of the
//     slab at position 8 (p % 4) + 2 i + p / 4 for wgmma step i, column p);
//     the next slab's loads are in flight while the current slab's
//     products run;
//   - an output tile is 128 rows (a warpgroup each 64) by BN columns, BN
//     chosen per phase (8-64) for the least time (pick_bn); every tile
//     sums its whole depth, slab after slab in order, so a product is the
//     same bit for bit on every tile shape: the backward's recompute over
//     all (T - 1) K B rows at once equals the forward's transition;
//   - registers: __maxnreg__(224) a thread (ptxas gives a 288-thread CTA
//     under __launch_bounds__ 168, and the consumers' loop with the
//     elementwise phases spilled there; setmaxnreg did not change that),
//     and the elementwise phases keep 4 particles' loads in flight, not
//     8: 0 bytes spilled.
//
// What bounds a launch (H100): at K = 25 the products, 5.9 GFLOP a step
// in three TF32 passes, 12 us at 495 TFLOP/s; a slab's loads, split and
// wait make a tile latency-bound above that (a slab takes about as long at
// 8 columns as at 64), and each step adds four grid barriers and the
// elementwise phases. At K = 1 latency alone: 24 steps of dependent
// phases.
//
// Route "wgmma" in bfloat16 (MultiDMM(bf16_gtf=True)):
//   bfvi_scan_fwd_bf16_wgmma_kernel, bfvi_scan_bwd_bf16_wgmma_kernel
// which bf16_scan_plan gives every bf16 launch that no cluster of
// bf16_scan.cuh holds (K > 64 particles, wide transitions). The same
// grid, phases, job tables, producer warp and elementwise phases as the
// float32 wgmma route (the phase machinery below is one template over the
// two engines), with bfvi_scan.cuh's bf16 rounding points (its header):
//   - products on wgmma.mma_async m64nNk16, bf16 operands, f32
//     accumulators: one pass, not three; tiles of 128 rows by up to 128
//     columns (pick_bn<true>: a slab of A costs as many bytes of L2 as
//     256 weight rows, so wide tiles, which read A fewer times, win);
//   - B, the weights, as one bfloat16 image a matrix (bf16_wgmma_pack),
//     K-major in the 128-byte swizzle, 64-deep slabs, rows padded to 128:
//     a 16 KB stage holds a 128-row tile's slab, a ring of 5. bf16 wgmma
//     could read B MN-major, so that W as it is would serve both the
//     forward products and the input-gradient ones; each direction has its
//     own K-major image all the same, because a K-major tile of bn rows is
//     bn 128-byte rows, one contiguous copy of what the tile reads at every
//     width bn, where an MN-major tile narrower than 64 columns would copy
//     whole 64-column rows of the swizzle atom (8x the bytes at bn = 8);
//     the two images are packed once per autograd call;
//   - A, the activations, f32 in L2 as on the float32 route, copied by
//     cp.async into a warpgroup's slots three slabs ahead of its products
//     (each thread its own 16-byte pieces: per 64-deep slab and row, depth
//     16 i + 4 q + (0..3) for k16 step i, so that the four threads of a
//     row copy 64 consecutive bytes a step), then rounded to bf16
//     (cvt.rn.bf16x2.f32, as the tile engine rounds its fragments) into
//     one of the warpgroup's two A stages in shared memory (K-major, the
//     swizzle, the images' order of depth within each step), where wgmma
//     reads it; each step still sums exactly its 16 depths. A in registers
//     was the first design: two register sets of fragments for two slabs
//     in flight spilled hundreds of bytes at 168 registers (and at 224),
//     one set fits but waits for every slab's products;
//   - two slabs' products in flight: the wait after slab s is for slab
//     s - 1's group (wg_wait<1>), whose B stage is freed then;
//   - every output sums its depth slab after slab, and each slab's k16
//     steps, in one order on every tile width: the backward's recompute
//     over all (T - 1) K B rows equals the forward's transition bit for
//     bit, also at a bf16 rounding midpoint;
//   - the backward writes the rows of the tiled bf16 backward
//     (emit_bf16_rows: xs/ys/z in bfloat16, BIAS_CHUNKS partials of the
//     bias sums), which gtf_wgrad_bf16_kernel takes unchanged;
//   - registers: at most 168 a thread (kBRegs: 288 threads, three of the
//     nine warps on one of the SM's four register files), 0 spilled.
// Bound (H100, z = h = 768, K = 25): 425 GFLOP over a forward, 0.43 ms at
// 989 TFLOP/s; the backward three times that. What the launch spends
// beyond it (scripts/bf16_wgmma_parts.py on the card): the elementwise
// phases (about a third of the forward), the epilogues' f32 stores, and
// per slab the loads of A in f32 from L2 (32 KB a 128-row slab), as on the
// float32 route.
//
// Layouts, arguments and the rows that the backward writes: bfvi_scan.cuh.
// D and H must be multiples of 4 (the wrapper zero-pads), of 16 on the
// bf16 route.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfvi_scan.cuh"

namespace {
namespace f32scan {

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

// Waits for phase `parity` of the mbarrier at `bar` to complete. A wait
// still open after 10 s traps, so a fault ends the launch with an error
// instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  if (done) return;
  const unsigned long long t0 = now_ns();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (now_ns() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// A TMA bulk copy of `bytes` (a multiple of 16) from global memory into
// this CTA's shared memory, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1,024 bytes apart (the stage's base is 1,024-aligned).
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
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// A value that every thread of the warp holds, so marked for the compiler
// (a broadcast from lane 0): wgmma chains whose trip counts it cannot prove
// uniform are serialized.
__device__ __forceinline__ int uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma.mma_async m64nNk8, TF32 x TF32 -> f32: A from registers (the
// m16n8k8 fragment of each warp's 16 rows: a[0] (g, q), a[1] (g + 8, q),
// a[2] (g, q + 4), a[3] (g + 8, q + 4), g = lane / 4, q = lane % 4), B from
// shared memory (descriptor), accumulating into d.
template <int N>
struct Mma;
template <>
struct Mma<8> {
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Mma<16> {
  __device__ static void run(float (&d)[8], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Mma<32> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4],
                             uint64_t b) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Mma<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B from shared
// memory (K-major descriptors), accumulating into d.
#define F32SCAN_BMMA(N, OUTS, IN0)                                          \
  template <>                                                               \
  struct BMma<N> {                                                          \
    __device__ static void run(float (&d)[N / 2], uint64_t a, uint64_t b) { \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IN0 ", 0;\n"               \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "       \
          OUTS ", p, 1, 1, 0, 0;\n}\n"                                      \
          : F32SCAN_BACC##N                                                 \
          : "l"(a), "l"(b), "r"(1));                                        \
    }                                                                       \
  };
template <int N>
struct BMma;
#define F32SCAN_BACC8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
F32SCAN_BMMA(8, "{%0, %1, %2, %3}, %4, %5", 6)
#define F32SCAN_BACC16 F32SCAN_BACC8, "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
    "+f"(d[7])
F32SCAN_BMMA(16, "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9", 10)
#define F32SCAN_BACC32 F32SCAN_BACC16, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
F32SCAN_BMMA(32, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
             "%13, %14, %15}, %16, %17", 18)
#define F32SCAN_BACC64 F32SCAN_BACC32, "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), \
    "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
F32SCAN_BMMA(64, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
             "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
             "%25, %26, %27, %28, %29, %30, %31}, %32, %33", 34)
#define F32SCAN_BACC128 F32SCAN_BACC64, \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
    "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
    "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
    "+f"(d[62]), "+f"(d[63])
F32SCAN_BMMA(128, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
             "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
             "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
             "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
             "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
             "%61, %62, %63}, %64, %65", 66)
#undef F32SCAN_BMMA

// ---------------------------------------------------------------------------
// Route "wgmma": the product engine
// ---------------------------------------------------------------------------

constexpr int kWgThreads = NT + 32;  // two consumer warpgroups, a producer warp
// Registers a thread: 288 x 224 of the SM's 65,536. (Under
// __launch_bounds__ ptxas gives a CTA of 288 threads 168, as if it were
// 384, and the consumers' loop and the elementwise phases spill there.)
constexpr int kWgRegs = 224;
// The bf16 kernels' cap: the most registers that 288 threads can hold,
// three of the nine warps sharing one of the SM's four register files of
// 16,384 (168 x 32 x 3 = 16,128); above it, under kWgRegs, the launch
// found no room (cudaErrorInvalidConfiguration).
constexpr int kBRegs = 168;
// The elementwise phases' particles in flight a thread (bfvi_scan.cuh's
// CH, 8 there).
constexpr int kWgChunk = 4;
// The bf16 backward's: at 4 its kernel spilled 24 bytes at 168 registers
// (the bf16 engine's 64 accumulators a thread); 2 spill none and took the
// same time on the card.
constexpr int kBBwdChunk = 2;
constexpr int kTileRows = 128;       // a tile's rows: 64 a consumer warpgroup
constexpr int kMaxBN = 64;
constexpr int kStages = 8;
constexpr int kSlab = 32;            // a stage's depth: one 128-byte row
constexpr int kHalf = kMaxBN * 128;  // a stage's hi (or lo) rows, bytes
constexpr int kStageBytes = 2 * kHalf;
constexpr int kRedFloats = 3 * 2 * (NT / 2);  // bfvi_scan.cuh's group_sum
constexpr int kWgSmem = kStages * kStageBytes + kRedFloats * 4 + 1024;
constexpr int kImgRows = kMaxBN;     // image rows are padded to this
// The bf16 engine: tiles of 128 rows by up to kBMaxBN columns (a
// warpgroup 64 x 128: 64 accumulators a thread); a stage is one 64-deep
// slab (128 bytes a row) of a tile's bf16 weight rows (16 KB), an A stage
// that of a warpgroup's 64 rows of A in bf16 (8 KB); a slot holds a
// warpgroup's 64 rows of a slab of A in f32 as they arrive from L2
// (cp.async), kBSlots slabs ahead. The ring: 5 weight stages, two A
// stages and kBSlots slots a warpgroup, 208 KB.
constexpr int kBMaxBN = 128;
constexpr int kBImgRows = kBMaxBN;  // bf16 image rows are padded to this
constexpr int kBSlab = 64;
constexpr int kBStageBytes = kBMaxBN * 128;
constexpr int kBAStageBytes = 64 * 128;
constexpr int kBStages = 5;
constexpr int kBSlots = 3;
constexpr int kBSlotBytes = 64 * kBSlab * 4;
constexpr int kBAStages = kBStages * kBStageBytes;  // the A stages' offset
constexpr int kBASlots = kBAStages + 4 * kBAStageBytes;  // the slots'
constexpr int kBRingBytes = kBASlots + 2 * kBSlots * kBSlotBytes;
constexpr int kBWgSmem = kBRingBytes + kRedFloats * 4 + 1024;
// A slab of a tile reads 128 rows of A in f32 (32 KB) from L2 beside bn
// rows of bf16 weights (128 bytes each): A's bytes are those of 256 weight
// rows, so a wide tile costs little more than a narrow one and saves
// reading A again.
constexpr int kBSlabCost = 256;

// One weight matrix's TF32 images (f32_pack): N rows by K deep, as
// ceil(K / 32) slabs of npad rows of 32 values (128 bytes, swizzled), hi
// and lo apart.
struct Mat {
  const float* hi;
  const float* lo;
  int npad;
};

// The matrices of both directions: the forward's w1 (2H + D x D), wg2,
// wn2 (D x H) and ws (D x D) as they are, (out, in); the backward's
// products read ws^T, wg2^T, wn2^T and the three blocks of w1^T.
enum { W1 = 0, WG2, WN2, WS, WS_T, WG2_T, WN2_T, G1_T, N1_T, ZL_T, kMats };
struct Mats {
  Mat m[kMats];
};

// One matrix's bfloat16 image (bf16_wgmma_pack): ceil(K / 64) slabs of
// npad rows of 64 values (128 bytes, swizzled); the same table.
struct BMat {
  const uint16_t* w;
  int npad;
};
struct BMats {
  BMat m[kMats];
};

// The ring and matrices of an engine: 3xTF32 (BF16 false) or bf16.
template <bool BF16>
struct Eng {
  using M = Mats;
  static constexpr int kStages = f32scan::kStages, kSlab = f32scan::kSlab;
  static constexpr int kRingBytes = f32scan::kStages * kStageBytes;
};
template <>
struct Eng<true> {
  using M = BMats;
  static constexpr int kStages = kBStages, kSlab = kBSlab;
  static constexpr int kRingBytes = f32scan::kBRingBytes;
};

// A product of a phase: rows M of A (its first K columns) times matrix
// `mat` (its N rows), delivered through bfvi_scan.cuh's epilogue.
struct WJob {
  tf32x3::Operand a;
  int M, N, K, mat;
  Epi ep;
};

// The ring's state in a thread: shared-memory addresses of stage 0 and of
// the stages' full and empty mbarriers, and the slabs that this thread's
// role has passed (the producer's and the consumers' counts agree slab
// for slab: both walk the same schedule).
struct Ring {
  uint32_t base, full, empty;
  uint32_t it;
};

// The tile width of a phase: the one whose tiles take the least time,
// rounds of the grid times a tile's cost (the larger width on a tie). A
// slab of a tile costs about as much at 8 columns as at 64 (its loads,
// the split, the wait for its products), so a tile's cost is its width
// plus kSlabCost columns' worth.
constexpr int kSlabCost = 64;
template <bool BF16>
__device__ __forceinline__ int pick_bn(const WJob* jobs, int nj) {
  constexpr int max_bn = BF16 ? kBMaxBN : kMaxBN;
  constexpr int slab_cost = BF16 ? kBSlabCost : kSlabCost;
  const int mt = (jobs[0].M + kTileRows - 1) / kTileRows;
  int best = max_bn, best_cost = 0x7fffffff;
  for (int bn = max_bn; bn >= 8; bn >>= 1) {
    int tiles = 0;
    for (int j = 0; j < nj; ++j) tiles += mt * ((jobs[j].N + bn - 1) / bn);
    const int cost = ((tiles + (int)gridDim.x - 1) / (int)gridDim.x) *
                     (slab_cost + bn);
    if (cost < best_cost) {
      best_cost = cost;
      best = bn;
    }
  }
  return best;
}

// The producer (one thread): each 32-deep slab of the tile's weight rows
// [n0, n0 + bn), hi and lo, into the next stage once it is free.
__device__ __forceinline__ void produce(const Mat& m, int n0, int bn, int ns,
                                       Ring& rg) {
  const int bytes = bn * 128;
  for (int s = 0; s < ns; ++s, ++rg.it) {
    const uint32_t st = rg.it % kStages, round = rg.it / kStages;
    mbar_wait(rg.empty + 8 * st, (round & 1) ^ 1);
    const uint32_t full = rg.full + 8 * st;
    mbar_expect(full, 2 * bytes);
    const size_t off = ((size_t)s * m.npad + n0) * kSlab;
    const uint32_t dst = rg.base + st * kStageBytes;
    bulk_copy(dst, m.hi + off, bytes, full);
    bulk_copy(dst + kHalf, m.lo + off, bytes, full);
  }
}

// A consumer warpgroup's 64 rows of a tile: acc = A[m0 + 64 wg + (0..63),
// :K] times rows [n0, n0 + BN) of the matrix, slab by slab from the ring,
// then the epilogue on each pair of columns.
template <int BN>
__device__ __forceinline__ void consume(const WJob& jb, int m0, int n0,
                                       int ns, Ring& rg) {
  const int t = threadIdx.x, lane = t & 31, q = lane & 3;
  const int r0 = m0 + 64 * (t >> 7) + 16 * ((t >> 5) & 3) + (lane >> 2);
  const int r1 = r0 + 8, M = jb.M, K = jb.K;
  const bool v0 = r0 < M, v1 = r1 < M;
  const float* p0 = jb.a.p + (size_t)(v0 ? r0 : 0) * jb.a.ld;
  const float* p1 = jb.a.p + (size_t)(v1 ? r1 : 0) * jb.a.ld;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // A thread's 8 values of each row in a slab: depth 32 s + 8 q + (0..7).
  float raw[16];
  auto load = [&](int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kSlab * s + 8 * q + 4 * h;
      const bool ok = k < K;  // K is a multiple of 4
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (ok && v0) x = __ldcg(reinterpret_cast<const float4*>(p0 + k));
      if (ok && v1) y = __ldcg(reinterpret_cast<const float4*>(p1 + k));
      raw[4 * h] = x.x; raw[4 * h + 1] = x.y; raw[4 * h + 2] = x.z;
      raw[4 * h + 3] = x.w;
      raw[8 + 4 * h] = y.x; raw[9 + 4 * h] = y.y; raw[10 + 4 * h] = y.z;
      raw[11 + 4 * h] = y.w;
    }
  };
  // Step i of the slab: a[0] = A[r0][j], a[1] = A[r1][j], a[2] = A[r0][j + 1],
  // a[3] = A[r1][j + 1] with j = 8 q + 2 i (the images' order of depth).
  // The next slab's loads go out as soon as this slab's values are split,
  // and arrive while its products run.
  uint32_t hi[4][4], lo[4][4];
  load(0);
  fence_acc(acc);
  for (int s = 0; s < ns; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x[4] = {raw[2 * i], raw[8 + 2 * i], raw[2 * i + 1],
                          raw[9 + 2 * i]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[i][e] = tf32_bits(x[e]);
        lo[i][e] = tf32_bits(x[e] - __uint_as_float(hi[i][e]));
      }
    }
    if (s + 1 < ns) load(s + 1);
    const uint32_t st = rg.it % kStages;
    mbar_wait(rg.full + 8 * st, (rg.it / kStages) & 1);
    const uint32_t b_hi = rg.base + st * kStageBytes, b_lo = b_hi + kHalf;
    wg_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Mma<BN>::run(acc, lo[i], desc(b_hi + 32 * i));
      Mma<BN>::run(acc, hi[i], desc(b_lo + 32 * i));
      Mma<BN>::run(acc, hi[i], desc(b_hi + 32 * i));
    }
    wg_commit();
    // The fragments are read until the products are done; the other
    // warpgroup's products keep the tensor cores busy meanwhile.
    wg_wait<0>();
    fence_frag(hi);
    fence_frag(lo);
    if (lane == 0) mbar_arrive(rg.empty + 8 * st);
    ++rg.it;
  }
  fence_acc(acc);
  const Epi ep = jb.ep;
  const int N = jb.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    if (n < N) {
      if (v0) epi_pair<false>(ep, r0, n, acc[4 * j], acc[4 * j + 1]);
      if (v1) epi_pair<false>(ep, r1, n, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The bf16 engine's producer (one thread): each 64-deep slab of the tile's
// bf16 weight rows [n0, n0 + bn) into the next stage once it is free.
__device__ __forceinline__ void produce_bf16(const BMat& m, int n0, int bn,
                                             int ns, Ring& rg) {
  const int bytes = bn * 128;
  for (int s = 0; s < ns; ++s, ++rg.it) {
    const uint32_t st = rg.it % kBStages, round = rg.it / kBStages;
    mbar_wait(rg.empty + 8 * st, (round & 1) ^ 1);
    const uint32_t full = rg.full + 8 * st;
    mbar_expect(full, bytes);
    bulk_copy(rg.base + st * kBStageBytes,
              m.w + ((size_t)s * m.npad + n0) * kBSlab, bytes, full);
  }
}

// Generic-proxy writes to shared memory before an async-proxy read
// (wgmma) of them; the warpgroup's own barrier (named barrier 1 + wg over
// its 128 threads; 8 is the elementwise phases', lanes_sync).
__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}
// 16 bytes from global memory (through L2 only) into shared memory,
// asynchronously; `bytes` 0 fills them with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bf16 engine's consumer warpgroup: acc = A[m0 + 64 wg + (0..63), :K]
// times rows [n0, n0 + BN) of the matrix, ns slabs of four 16-deep steps
// from the ring (past K the image and A hold zeros, which add exact
// zeros), then the epilogue, which rounds each sum to bf16
// (epi_pair<true>). A's slabs come from L2 by cp.async into the
// warpgroup's slots, kBSlots slabs ahead of the products (each thread
// copies and later reads only its own 16-byte pieces: its rows r0 and r1,
// depth 64 s + 16 h + 4 q + (0..3) for step h); each slab is rounded to
// bf16 and written into one of the warpgroup's two A stages (K-major, the
// 128-byte swizzle, the images' order of depth), where wgmma reads it, so
// that two slabs' products are in flight.
template <int BN>
__device__ __forceinline__ void consume_bf16(const WJob& jb, int m0, int n0,
                                             int ns, Ring& rg) {
  const int t = threadIdx.x, lane = t & 31, q = lane & 3, wg = t >> 7;
  const int row0 = 16 * ((t >> 5) & 3) + (lane >> 2);  // in the 64 rows
  const int r0 = m0 + 64 * wg + row0, r1 = r0 + 8, M = jb.M, K = jb.K;
  const bool v0 = r0 < M, v1 = r1 < M;
  const float* p0 = jb.a.p + (size_t)(v0 ? r0 : 0) * jb.a.ld;
  const float* p1 = jb.a.p + (size_t)(v1 ? r1 : 0) * jb.a.ld;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // Piece c of this thread in a slot at 16 (128 c + thread), so that a
  // warp's 16-byte accesses take 32 distinct banks: pieces 0-3 row r0,
  // 4-7 row r1, step h = c % 4.
  const uint32_t a_base = rg.base + kBAStages + 2 * wg * kBAStageBytes;
  const uint32_t f_base = rg.base + kBASlots + wg * kBSlots * kBSlotBytes +
                          16 * (t & 127);
  auto fetch = [&](int s) {
    const uint32_t dst = f_base + (s % kBSlots) * kBSlotBytes;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = kBSlab * s + 16 * h + 4 * q;
      const bool ok = k < K;  // K is a multiple of 16
      cp_async16(dst + 2048 * h, ok ? p0 + k : p0, ok && v0 ? 16 : 0);
      cp_async16(dst + 2048 * (4 + h), ok ? p1 + k : p1, ok && v1 ? 16 : 0);
    }
  };
  // Step i's depths 4q + (0, 1) at the positions 2q (+1) of the step, 4q +
  // (2, 3) at 2q + 8 (+1) (bf16_wgmma_pack's order): byte 32 i + 4 q of
  // the 128-byte row in chunk 2 i, and in chunk 2 i + 1, each chunk at
  // chunk ^ (row % 8).
  const uint32_t o0 = row0 * 128 + 4 * q, o1 = o0 + 8 * 128;
  const int x0 = row0 & 7;  // row0 + 8 has the same swizzle
  auto stage_a = [&](int s, uint32_t dst) {
    const uint32_t src = f_base + (s % kBSlots) * kBSlotBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = ld_shared4(src + 2048 * i);
      const float4 y = ld_shared4(src + 2048 * (4 + i));
      const uint32_t c0 = (uint32_t)((2 * i) ^ x0) << 4;
      const uint32_t c1 = (uint32_t)((2 * i + 1) ^ x0) << 4;
      st_shared(dst + o0 + c0, tf32x3::bf16x2_(x.x, x.y));
      st_shared(dst + o0 + c1, tf32x3::bf16x2_(x.z, x.w));
      st_shared(dst + o1 + c0, tf32x3::bf16x2_(y.x, y.y));
      st_shared(dst + o1 + c1, tf32x3::bf16x2_(y.z, y.w));
    }
  };
  // One commit group a slab (empty past the tile's last), so that the
  // wait for slab s is always "all but the kBSlots - 1 newest".
#pragma unroll
  for (int p = 0; p < kBSlots; ++p) {
    if (p < ns) fetch(p);
    cp_async_commit();
  }
  fence_acc(acc);
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<kBSlots - 1>();
    // The A stage of slab s - 2, whose products the wait of slab s - 1
    // saw done; the slot is refilled with slab s + kBSlots at once.
    const uint32_t a_s = a_base + (s & 1) * kBAStageBytes;
    stage_a(s, a_s);
    if (s + kBSlots < ns) fetch(s + kBSlots);
    cp_async_commit();
    fence_async_cta();
    wg_bar(wg);
    const uint32_t st = rg.it % kBStages;
    mbar_wait(rg.full + 8 * st, (rg.it / kBStages) & 1);
    const uint32_t b = rg.base + st * kBStageBytes;
    wg_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      BMma<BN>::run(acc, desc(a_s + 32 * i), desc(b + 32 * i));
    wg_commit();
    // Slab s - 1's products are done: its B stage is free.
    wg_wait<1>();
    if (s > 0 && lane == 0)
      mbar_arrive(rg.empty + 8 * ((rg.it - 1) % kBStages));
    ++rg.it;
  }
  wg_wait<0>();
  if (lane == 0) mbar_arrive(rg.empty + 8 * ((rg.it - 1) % kBStages));
  fence_acc(acc);
  const Epi ep = jb.ep;
  const int N = jb.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    if (n < N) {
      if (v0) epi_pair<true>(ep, r0, n, acc[4 * j], acc[4 * j + 1]);
      if (v1) epi_pair<true>(ep, r1, n, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The tiles of one phase's jobs (all of M rows), in grid-stride order,
// through the producer's or the consumers' side of the ring, on the
// 3xTF32 engine or (BF16) the bf16 one.
template <bool PRODUCER, bool BF16>
__device__ __forceinline__ void run_phase(const WJob* jobs, int nj,
                                          const typename Eng<BF16>::M& mats,
                                          Ring& rg) {
  // (The producer is one thread: the others of its warp have left.)
  const int bn = PRODUCER ? pick_bn<BF16>(jobs, nj)
                          : uniform(pick_bn<BF16>(jobs, nj));
  const int mt = (jobs[0].M + kTileRows - 1) / kTileRows;
  int total = 0;
  for (int j = 0; j < nj; ++j) total += mt * ((jobs[j].N + bn - 1) / bn);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int j = 0, local = tile;
    while (local >= mt * ((jobs[j].N + bn - 1) / bn)) {
      local -= mt * ((jobs[j].N + bn - 1) / bn);
      ++j;
    }
    const WJob& jb = jobs[j];
    const int m0 = (local % mt) * kTileRows, n0 = (local / mt) * bn;
    constexpr int slab = Eng<BF16>::kSlab;
    const int ns = (jb.K + slab - 1) / slab;
    if constexpr (PRODUCER && BF16) {
      produce_bf16(mats.m[jb.mat], n0, bn, ns, rg);
    } else if constexpr (PRODUCER) {
      produce(mats.m[jb.mat], n0, bn, ns, rg);
    } else if constexpr (BF16) {
      switch (bn) {
        case 128: consume_bf16<128>(jb, m0, n0, uniform(ns), rg); break;
        case 64: consume_bf16<64>(jb, m0, n0, uniform(ns), rg); break;
        case 32: consume_bf16<32>(jb, m0, n0, uniform(ns), rg); break;
        case 16: consume_bf16<16>(jb, m0, n0, uniform(ns), rg); break;
        default: consume_bf16<8>(jb, m0, n0, uniform(ns), rg); break;
      }
    } else {
      switch (bn) {
        case 64: consume<64>(jb, m0, n0, uniform(ns), rg); break;
        case 32: consume<32>(jb, m0, n0, uniform(ns), rg); break;
        case 16: consume<16>(jb, m0, n0, uniform(ns), rg); break;
        default: consume<8>(jb, m0, n0, uniform(ns), rg); break;
      }
    }
  }
}

// The grid barrier of the consumer warps (bfvi_scan.cuh's grid_sync on the
// NT threads that take part; the producer warp never waits on the grid).
__device__ __forceinline__ void consumer_grid_sync(unsigned* bar,
                                                   unsigned& target) {
  lanes_sync();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned long long t0 = now_ns();
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if ((int)(v - target) >= 0) break;
      if (now_ns() - t0 > 10000000000ull) __trap();
      __nanosleep(100);
    }
    __threadfence();
  }
  lanes_sync();
}

// The jobs of the forward's product phase ph at step t >= 1 (0: A =
// [relu(gate_1) | relu(nonlin_1) | z_lin]; 1: gate_2's and nonlin_2's; 2:
// z_to_std's), bfvi_scan.cuh's scan_fwd's; returns their number.
__device__ __forceinline__ int fwd_jobs(const FwdArgs& a, int t, int ph,
                                        WJob* jobs) {
  const Dims& s = a.s;
  const int D = s.D, H = s.H, R = s.K * s.B;
  const int la = 2 * H + D, lw = la + 3 * D;
  float* A = a.work;
  float* G = A + la;
  float* N = G + D;
  float* S = N + D;
  const Weights& w = a.w;
  if (ph == 0) {
    const float* Z = a.z_traj + (size_t)(t - 1) * R * D;
    jobs[0] = WJob{{Z, D}, R, la, D, W1, store_to(A, lw, w.b1, la)};
    jobs[0].ep.relu_cols = 2 * H;
    return 1;
  }
  if (ph == 1) {
    jobs[0] = WJob{{A, lw}, R, D, H, WG2, store_to(G, lw, w.bg2, D)};
    jobs[1] = WJob{{A + H, lw}, R, D, H, WN2, store_to(N, lw, w.bn2, D)};
    return 2;
  }
  jobs[0] = WJob{{N, lw}, R, D, D, WS, store_to(S, lw, w.bs, D)};
  return 1;
}

// bfvi_scan.cuh's scan_fwd with the products on this engine (one call
// site of the inlined engine), 3xTF32 or (BF16) bf16; the producer walks
// the same phases and only loads.
template <bool PRODUCER, bool BF16>
__device__ __forceinline__ void scan_fwd_wg(const FwdArgs& a,
                                            const typename Eng<BF16>::M& mats,
                                            Ring& rg, float* red) {
  unsigned target = 0;
  for (int t = 0; t < a.s.T; ++t) {
    for (int ph = 0; t > 0 && ph < 3; ++ph) {
      WJob jobs[2];
      const int nj = fwd_jobs(a, t, ph, jobs);
      run_phase<PRODUCER, BF16>(jobs, nj, mats, rg);
      if (!PRODUCER) {
        if (ph == 2 && a.rows != nullptr) copy_fwd_rows(a, t);
        consumer_grid_sync(a.bar, target);
      }
    }
    if (!PRODUCER) {
      fwd_elementwise<kWgChunk>(a, t, red);
      if (t + 1 < a.s.T) consumer_grid_sync(a.bar, target);
    }
  }
}

// The jobs of the backward's product phase ph (bfvi_scan.cuh's scan_bwd's):
// 0-2 the transition of every step t >= 1 recomputed at once (xs = [h1 |
// hn | z_nonlin] and, in ys, z_lin, a2 and s_raw); at step t, 3: d_znon +=
// d_sraw @ ws and d_a1 = (d_a2 @ wg2) * (h1 > 0); 4: d_b1 = (d_znon @ wn2)
// * (hn > 0); 5: the cotangent of z_{t-1} in three partials (gate_1,
// nonlin_1, z_lin), which the next elementwise phase adds in order (and
// on the bf16 route rounds: the partials keep their f32 sums).
__device__ __forceinline__ int bwd_jobs(const BwdArgs& a, int t, int ph,
                                        WJob* jobs) {
  const Dims& s = a.s;
  const int D = s.D, H = s.H, R = s.K * s.B;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D;
  const int RA = (s.T - 1) * R;
  const Weights& w = a.w;
  if (ph == 0) {
    jobs[0] = WJob{{a.z_traj, D}, RA, la, D, W1,
                   Epi{EP_STORE, w.b1, 2 * H, a.xs, lx, a.ys + 2 * H, ly,
                       2 * H, nullptr, 0, 0}};
    return 1;
  }
  if (ph == 1) {
    jobs[0] = WJob{{a.xs, lx}, RA, D, H, WG2,
                   store_to(a.ys + la, ly, w.bg2, D)};
    jobs[1] = WJob{{a.xs + H, lx}, RA, D, H, WN2,
                   store_to(a.xs + 2 * H, lx, w.bn2, D)};
    return 2;
  }
  if (ph == 2) {
    jobs[0] = WJob{{a.xs + 2 * H, lx}, RA, D, D, WS,
                   store_to(a.ys + la + 2 * D, ly, w.bs, D)};
    return 1;
  }
  float* X = a.xs + (size_t)(t - 1) * R * lx;
  float* Y = a.ys + (size_t)(t - 1) * R * ly;
  if (ph == 3) {
    jobs[0] = WJob{{Y + la + 2 * D, ly}, R, D, D, WS_T,
                   store_to(Y + la + D, ly, nullptr, D)};
    jobs[0].ep.mode = EP_ADD;
    jobs[1] = WJob{{Y + la, ly}, R, H, D, WG2_T, store_to(Y, ly, nullptr, H)};
    jobs[1].ep.mode = EP_MASK;
    jobs[1].ep.mask = X;
    jobs[1].ep.ldm = lx;
    return 2;
  }
  if (ph == 4) {
    jobs[0] = WJob{{Y + la + D, ly}, R, H, D, WN2_T,
                   store_to(Y + H, ly, nullptr, H)};
    jobs[0].ep.mode = EP_MASK;
    jobs[0].ep.mask = X + H;
    jobs[0].ep.ldm = lx;
    return 1;
  }
  const size_t RD = (size_t)R * D;
  jobs[0] = WJob{{Y, ly}, R, D, H, G1_T, store_to(a.gz, D, nullptr, D)};
  jobs[1] = WJob{{Y + H, ly}, R, D, H, N1_T,
                 store_to(a.gz + RD, D, nullptr, D)};
  jobs[2] = WJob{{Y + 2 * H, ly}, R, D, D, ZL_T,
                 store_to(a.gz + 2 * RD, D, nullptr, D)};
  for (int j = 0; j < 3; ++j) jobs[j].ep.keep_f32 = 1;
  return 3;
}

// bfvi_scan.cuh's scan_bwd with the products on this engine, its phases in
// one sequence (one call site of the inlined engine): the recompute's
// three products, then for t = T - 1 down to 1 the elementwise VJP of step
// t and its three products, a grid barrier after each; the elementwise
// VJP of step 0 last. On the bf16 route the phase of the z cotangent's
// products also writes step t's rows in bfloat16 (emit_bf16_rows).
template <bool PRODUCER, bool BF16>
__device__ __forceinline__ void scan_bwd_wg(const BwdArgs& a,
                                            const typename Eng<BF16>::M& mats,
                                            Ring& rg, float* red) {
  unsigned target = 0;
  const int n_prod = a.s.T > 1 ? 3 * a.s.T : 0;
  int t = a.s.T - 1;
  for (int i = 0; i < n_prod; ++i) {
    const int ph = i < 3 ? i : 3 + (i - 3) % 3;
    if (ph == 3 && !PRODUCER) {
      bwd_elementwise<BF16, BF16 ? kBBwdChunk : kWgChunk>(a, t, red);
      consumer_grid_sync(a.bar, target);
    }
    WJob jobs[3];
    const int nj = bwd_jobs(a, t, ph, jobs);
    run_phase<PRODUCER, BF16>(jobs, nj, mats, rg);
    if (!PRODUCER) {
      if constexpr (BF16) {
        if (ph == 5) emit_bf16_rows(a, t);
      }
      consumer_grid_sync(a.bar, target);
    }
    if (ph == 5) --t;
  }
  if (!PRODUCER) bwd_elementwise<BF16, BF16 ? kBBwdChunk : kWgChunk>(a, 0, red);
}

// The kernels' start: the ring's mbarriers (full: the producer's arrival
// and the copies' bytes; empty: one arrival per consumer warp), the
// 1,024-aligned base of the stages, and the elementwise phases' scratch
// after them.
struct WgSmem {
  Ring rg;
  float* red;
};
template <bool BF16>
__device__ __forceinline__ WgSmem wg_setup(char* raw, uint64_t* bars) {
  constexpr int stages = Eng<BF16>::kStages;
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t pad = ((raw_addr + 1023u) & ~1023u) - raw_addr;
  WgSmem sm;
  sm.rg.base = raw_addr + pad;
  sm.rg.full = smem_u32(bars);
  sm.rg.empty = smem_u32(bars + stages);
  sm.rg.it = 0;
  sm.red = reinterpret_cast<float*>(raw + pad + Eng<BF16>::kRingBytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(sm.rg.full + 8 * i, 1);
      mbar_init(sm.rg.empty + 8 * i, NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

__global__ void __maxnreg__(kWgRegs)
    bfvi_scan_fwd_wgmma_kernel(FwdArgs a, Mats mats) {
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  WgSmem sm = wg_setup<false>(raw, bars);
  if (threadIdx.x >= NT) {
    if (threadIdx.x == NT) scan_fwd_wg<true, false>(a, mats, sm.rg, sm.red);
    return;
  }
  scan_fwd_wg<false, false>(a, mats, sm.rg, sm.red);
}

__global__ void __maxnreg__(kWgRegs)
    bfvi_scan_bwd_wgmma_kernel(BwdArgs a, Mats mats) {
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  WgSmem sm = wg_setup<false>(raw, bars);
  if (threadIdx.x >= NT) {
    if (threadIdx.x == NT) scan_bwd_wg<true, false>(a, mats, sm.rg, sm.red);
    return;
  }
  scan_bwd_wg<false, false>(a, mats, sm.rg, sm.red);
}

// The bf16 route's kernels (bf16_gtf): the same grid and phases on the
// bf16 engine.
__global__ void __maxnreg__(kBRegs)
    bfvi_scan_fwd_bf16_wgmma_kernel(FwdArgs a, BMats mats) {
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) uint64_t bars[2 * kBStages];
  WgSmem sm = wg_setup<true>(raw, bars);
  if (threadIdx.x >= NT) {
    if (threadIdx.x == NT) scan_fwd_wg<true, true>(a, mats, sm.rg, sm.red);
    return;
  }
  scan_fwd_wg<false, true>(a, mats, sm.rg, sm.red);
}

__global__ void __maxnreg__(kBRegs)
    bfvi_scan_bwd_bf16_wgmma_kernel(BwdArgs a, BMats mats) {
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) uint64_t bars[2 * kBStages];
  WgSmem sm = wg_setup<true>(raw, bars);
  if (threadIdx.x >= NT) {
    if (threadIdx.x == NT) scan_bwd_wg<true, true>(a, mats, sm.rg, sm.red);
    return;
  }
  scan_bwd_wg<false, true>(a, mats, sm.rg, sm.red);
}

// ---------------------------------------------------------------------------
// Route "column"
// ---------------------------------------------------------------------------

constexpr int kColThreads = 128;

// Floats of the GTF weights and biases in a column CTA's shared memory:
// [w1 | b1 | wg2 | bg2 | wn2 | bn2 | ws | bs], each weight either
// transposed, (in, out), for the transition's products, or as it is,
// (out, in), for the input-gradient products: either way element (k, n)
// of a product's weight lies at k N + n.
__host__ __device__ inline int col_weight_floats(int D, int H) {
  const int la = 2 * H + D;
  return la * D + la + 2 * (D * H + D) + D * D + D;
}

// A CTA's shared-memory bytes for `rows` particle rows: the weights, then
// the forward's z (rows x D) and work rows [A | G | N | S] (rows x
// (2H + 4D)); the backward's recompute takes the same, its walk in reverse
// the step's xs (2H + D) and ys (2H + 4D) rows and the z cotangent (D).
__host__ __device__ inline int col_smem_bytes(int bwd, int rows, int D, int H) {
  const int la = 2 * H + D, lw = la + 3 * D;
  const int fwd = D + lw, walk = la + lw + D;
  return 4 * (col_weight_floats(D, H) + rows * (bwd && walk > fwd ? walk : fwd));
}

struct ColW {
  float *w1, *b1, *wg2, *bg2, *wn2, *bn2, *ws, *bs;
};

__device__ __forceinline__ ColW col_weights(float* sm, int D, int H) {
  const int la = 2 * H + D;
  ColW c;
  c.w1 = sm;
  c.b1 = c.w1 + la * D;
  c.wg2 = c.b1 + la;
  c.bg2 = c.wg2 + D * H;
  c.wn2 = c.bg2 + D;
  c.bn2 = c.wn2 + D * H;
  c.ws = c.bn2 + D;
  c.bs = c.ws + D * D;
  return c;
}

// An R x C matrix from global memory into shared memory, transposed or
// as it is.
__device__ __forceinline__ void col_copy(const float* src, float* dst, int R,
                                         int C, bool transposed) {
  for (int i = threadIdx.x; i < R * C; i += kColThreads) {
    const int r = i / C, c = i - r * C;
    dst[transposed ? c * R + r : i] = __ldg(src + i);
  }
}

__device__ void col_load_weights(const Weights& g, const ColW& w, int D, int H,
                                 bool transposed) {
  const int la = 2 * H + D;
  col_copy(g.w1, w.w1, la, D, transposed);
  col_copy(g.b1, w.b1, 1, la, false);
  col_copy(g.wg2, w.wg2, D, H, transposed);
  col_copy(g.bg2, w.bg2, 1, D, false);
  col_copy(g.wn2, w.wn2, D, H, transposed);
  col_copy(g.bn2, w.bn2, 1, D, false);
  col_copy(g.ws, w.ws, D, D, transposed);
  col_copy(g.bs, w.bs, 1, D, false);
}

// out(r, n) = sum_k in[r ldi + k] W[k N + n] for the rows x N outputs, one
// thread an output, an FMA chain over k in order; epi(r, n, sum).
template <class E>
__device__ __forceinline__ void col_product(int rows, int N, int K,
                                            const float* in, int ldi,
                                            const float* W, E epi) {
  for (int i = threadIdx.x; i < rows * N; i += kColThreads) {
    const int r = i / N, n = i - r * N;
    const float* x = in + r * ldi;
    const float* wc = W + n;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) acc = fmaf(x[k], wc[k * N], acc);
    epi(r, n, acc);
  }
}

// The transition of the CTA's rows (weights transposed): z (rows x D) into
// the work rows [A = relu(gate_1) | relu(nonlin_1) | z_lin, G = gate_2's
// pre-activation, N = z_nonlin, S = z_to_std's], biases added. Every value
// also goes to out(product, row, column, value): 0 for A, 1 for G, 2 for
// N, 3 for S. The forward and the backward's recompute both run this.
template <class Out>
__device__ void col_transition(const ColW& w, int rows, int D, int H,
                               const float* z, float* work, Out out) {
  const int la = 2 * H + D, lw = la + 3 * D, H2 = 2 * H;
  col_product(rows, la, D, z, D, w.w1, [&](int r, int n, float acc) {
    float v = acc + w.b1[n];
    if (n < H2) v = fmaxf(v, 0.f);
    work[r * lw + n] = v;
    out(0, r, n, v);
  });
  __syncthreads();
  col_product(rows, D, H, work, lw, w.wg2, [&](int r, int n, float acc) {
    const float v = acc + w.bg2[n];
    work[r * lw + la + n] = v;
    out(1, r, n, v);
  });
  col_product(rows, D, H, work + H, lw, w.wn2, [&](int r, int n, float acc) {
    const float v = acc + w.bn2[n];
    work[r * lw + la + D + n] = v;
    out(2, r, n, v);
  });
  __syncthreads();
  col_product(rows, D, D, work + la + D, lw, w.ws,
              [&](int r, int n, float acc) {
                const float v = acc + w.bs[n];
                work[r * lw + la + 2 * D + n] = v;
                out(3, r, n, v);
              });
  __syncthreads();
}

// The lanes of an elementwise phase: each (column, d) of the CTA has tpe
// lanes of one warp (a power of two, at most K), which split its K
// particles (k = sub, sub + tpe, ...) and sum them by a butterfly.
struct ColLanes {
  int tpe, per_pass;
  __device__ ColLanes(int n_el, int K) {
    tpe = 1;
    while (tpe < 32 && tpe < K && n_el * tpe * 2 <= kColThreads) tpe *= 2;
    per_pass = kColThreads / tpe;
  }
};

// At each level a lane and its partner add the same two values, so every
// lane of the group ends with the same bits.
template <int N>
__device__ __forceinline__ void lane_sum(float (&v)[N], int tpe) {
  for (int o = 1; o < tpe; o <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// The CTA's columns [c0, c0 + g); its particle row k g + cl is row
// k B + c0 + cl of a step.
struct ColCols {
  int c0, g;
  __device__ ColCols(int B, int cols) {
    c0 = blockIdx.x * cols;
    g = min(cols, B - c0);
  }
  __device__ size_t row(int t1, int K, int B, int r) const {  // step t1 + 1
    const int k = r / g, cl = r - k * g;
    return ((size_t)t1 * K + k) * B + c0 + cl;
  }
};

// Step t's elementwise phase (bfvi_scan.cuh's fwd_elementwise) for the
// CTA's columns, from its work rows; the particles' z go to z_traj and to
// `z`, the next step's input.
__device__ void col_fwd_elementwise(const FwdArgs& a, int t, const ColCols& cc,
                                    float* z, const float* work) {
  const int D = a.s.D, H = a.s.H, K = a.s.K, M = a.s.M, B = a.s.B;
  const int la = 2 * H + D, lw = la + 3 * D, g = cc.g, n_el = g * D;
  const ColLanes ln(n_el, K);
  for (int base = 0; base < n_el; base += ln.per_pass) {
    const int e = base + threadIdx.x / ln.tpe, sub = threadIdx.x % ln.tpe;
    const bool live = e < n_el;
    const int cl = live ? e / D : 0, d = live ? e - cl * D : 0;
    const int b = cc.c0 + cl;
    const size_t bd = (size_t)b * D + d;
    float gm = 0.f, gs = 1.f, num_o = 0.f, den_o = 0.f;
    if (live) {
      gm = __ldg(a.glb_mean + bd);
      gs = __ldg(a.glb_std + bd);
      add_obs_experts(a.obs_mean, a.obs_std, a.obs_mask, t, M, B, b, D, d,
                      num_o, den_o);
    }
    float pm = gm, ps = gs;
    if (t > 0) {
      // PoE(global prior, GTF(z_k)) per particle, then the moment-matched
      // mixture over the K particles.
      const float p1 = 1.f / (gs * gs + kEps);
      float m3[3] = {0.f, 0.f, 0.f};
      for (int k = sub; live && k < K; k += ln.tpe) {
        const float* row = work + (size_t)(k * g + cl) * lw;
        float ppm, pps;
        poe2(gm, p1, row[la + d], row[2 * H + d], row[la + D + d],
             row[la + 2 * D + d], a.s.min_std, ppm, pps);
        m3[0] += ppm;
        m3[1] += pps * pps;
        m3[2] += ppm * ppm;
      }
      lane_sum(m3, ln.tpe);
      const float mu = m3[0] / (float)K;
      const float var = m3[1] / (float)K + m3[2] / (float)K - mu * mu;
      pm = mu;
      ps = sqrtf(fmaxf(var, 0.f));
    }
    // Masked, signed-precision PoE with the M observation experts.
    const float prec_p = 1.f / (ps * ps + kEps);
    const float num = pm * prec_p + num_o, den = prec_p + den_o;
    const bool low = den < kPrecFloor;
    const float safe = low ? 1.f : den;
    const float im = low ? 0.f : num / safe;
    const float is = low ? 1e3f : rsqrt_(safe);
    const size_t tbd = ((size_t)t * B + b) * D + d;
    if (live && sub == 0) {
      a.prior_mean[tbd] = pm;
      a.prior_std[tbd] = ps;
      a.infer_mean[tbd] = im;
      a.infer_std[tbd] = is;
    }
    float zs[1] = {0.f};
    for (int k = sub; live && k < K; k += ln.tpe) {
      const size_t o = (((size_t)t * K + k) * B + b) * D + d;
      const float zv = im + __ldg(a.eps + o) * is;
      a.z_traj[o] = zv;
      z[(k * g + cl) * D + d] = zv;
      zs[0] += zv;
    }
    lane_sum(zs, ln.tpe);
    if (live && sub == 0) a.samples[tbd] = zs[0] / (float)K;
  }
}

__global__ void __launch_bounds__(kColThreads, 4)
    bfvi_scan_fwd_column_kernel(FwdArgs a, int cols) {
  extern __shared__ __align__(16) float csm[];
  const int D = a.s.D, H = a.s.H, K = a.s.K, B = a.s.B, T = a.s.T;
  const int la = 2 * H + D;
  const ColCols cc(B, cols);
  const int rows = cc.g * K;
  const ColW w = col_weights(csm, D, H);
  float* z = csm + col_weight_floats(D, H);
  float* work = z + cols * K * D;
  col_load_weights(a.w, w, D, H, true);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      // The rows [h1 | hn | z_nonlin] of the transition, if asked for.
      float* fr = a.rows;
      col_transition(w, rows, D, H, z, work, [&](int ph, int r, int n,
                                                 float v) {
        if (fr == nullptr || ph == 1 || ph == 3 || (ph == 0 && n >= 2 * H))
          return;
        fr[cc.row(t - 1, K, B, r) * la + (ph == 0 ? n : 2 * H + n)] = v;
      });
    }
    col_fwd_elementwise(a, t, cc, z, work);
    __syncthreads();
  }
}

// Step t's elementwise VJP (bfvi_scan.cuh's bwd_elementwise) for the CTA's
// columns, on the step's xs/ys rows X and Y in shared memory (ys holding
// the recompute's z_lin, a2 and s_raw where the VJP writes its
// cotangents) and the z cotangent gz of step t + 1.
__device__ void col_bwd_elementwise(const BwdArgs& a, int t, const ColCols& cc,
                                    const float* X, float* Y,
                                    const float* gz) {
  const int D = a.s.D, H = a.s.H, K = a.s.K, M = a.s.M, B = a.s.B;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D, g = cc.g, n_el = g * D;
  const float min_std = a.s.min_std;
  const ColLanes ln(n_el, K);
  for (int base = 0; base < n_el; base += ln.per_pass) {
    const int e = base + threadIdx.x / ln.tpe, sub = threadIdx.x % ln.tpe;
    const bool live = e < n_el;
    const int cl = live ? e / D : 0, d = live ? e - cl * D : 0;
    const int b = cc.c0 + cl;
    const size_t bd = (size_t)b * D + d;
    const size_t tbd = ((size_t)t * B + b) * D + d;
    float prior_m = 0.f, prior_s = 1.f, g_smp = 0.f, g_im = 0.f, g_is = 0.f;
    float g_pm = 0.f, g_ps = 0.f, gm = 0.f, gs = 1.f;
    float num_o = 0.f, den_o = 0.f;
    if (live) {
      prior_m = __ldg(a.prior_mean + tbd);
      prior_s = __ldg(a.prior_std + tbd);
      g_smp = __ldg(a.g_smp + tbd);
      g_im = __ldg(a.g_im + tbd);
      g_is = __ldg(a.g_is + tbd);
      g_pm = __ldg(a.g_pm + tbd);
      g_ps = __ldg(a.g_ps + tbd);
      gm = __ldg(a.glb_mean + bd);
      gs = __ldg(a.glb_std + bd);
      add_obs_experts(a.obs_mean, a.obs_std, a.obs_mask, t, M, B, b, D, d,
                      num_o, den_o);
    }
    // Cotangents into z_t -> inference mean/std.
    const float gsm = g_smp / (float)K;
    float gg[2] = {0.f, 0.f};  // sum of gz, sum of gz * eps
    for (int k = sub; live && k < K; k += ln.tpe) {
      const float gzv = gz[(k * g + cl) * D + d] + gsm;
      gg[0] += gzv;
      gg[1] += gzv * __ldg(a.eps + (((size_t)t * K + k) * B + b) * D + d);
    }
    lane_sum(gg, ln.tpe);
    const float gim = g_im + gg[0];
    const float gis = g_is + gg[1];

    // Obs-PoE pieces, recomputed, and their VJP.
    const float var_p = prior_s * prior_s + kEps;
    const float prec_p = 1.f / var_p;
    const float num = prior_m * prec_p + num_o, den = prec_p + den_o;
    const bool low = den < kPrecFloor;
    const float safe = low ? 1.f : den;
    const float d_num = low ? 0.f : gim / safe;
    const float d_den =
        low ? 0.f : (-gim * num / (safe * safe) - 0.5f * gis * pow_m15_(safe));
    for (int m = 0; live && sub == 0 && m < M; ++m) {
      const size_t tm = (size_t)t * M + m;
      const bool mk = __ldg(a.obs_mask + tm * B + b) > 0.f;
      const size_t o = (tm * B + b) * D + d;
      const float om = __ldg(a.obs_mean + o), os = __ldg(a.obs_std + o);
      const float var_o = os * os + kEps;
      const float prec = sign_(os) / var_o;
      const float d_prec = mk ? d_num * om + d_den : 0.f;
      a.d_obs_mean[o] = mk ? d_num * prec : 0.f;
      a.d_obs_std[o] = d_prec * (-2.f * sign_(os) * os / (var_o * var_o));
    }
    const float d_prior_m = d_num * prec_p + g_pm;
    const float d_prec_pp = d_num * prior_m + d_den;
    const float d_prior_s = d_prec_pp * (-2.f * prior_s / (var_p * var_p)) + g_ps;

    if (t == 0) {  // the global prior was the prior at t = 0
      if (live && sub == 0) {
        a.d_glb_mean[bd] += d_prior_m;
        a.d_glb_std[bd] += d_prior_s;
      }
      continue;
    }

    // PoE2 + mixture, recomputed, then their VJP.
    const float p1 = 1.f / (gs * gs + kEps);
    float m3[3] = {0.f, 0.f, 0.f};
    for (int k = sub; live && k < K; k += ln.tpe) {
      const int r = k * g + cl;
      const float* y = Y + r * ly;
      float ppm, pps;
      poe2(gm, p1, y[la + d], y[2 * H + d], X[r * lx + 2 * H + d],
           y[la + 2 * D + d], min_std, ppm, pps);
      m3[0] += ppm;
      m3[1] += pps * pps;
      m3[2] += ppm * ppm;
    }
    lane_sum(m3, ln.tpe);
    const float mu = m3[0] / (float)K;
    const float var = m3[1] / (float)K + m3[2] / (float)K - mu * mu;
    const float ps_val = sqrtf(fmaxf(var, kEps));  // floored at _EPS, as on the TPU
    const float d_var = (var > 0.f) ? d_prior_s / (2.f * ps_val) : 0.f;
    float dg[2] = {0.f, 0.f};  // d_glb_mean, d_p1
    for (int k = sub; live && k < K; k += ln.tpe) {
      const int r = k * g + cl;
      float* y = Y + r * ly;
      const float sraw = y[la + 2 * D + d], zl = y[2 * H + d];
      const float zn = X[r * lx + 2 * H + d];
      const float gate = sigmoid_(y[la + d]);
      const float qm = (1.f - gate) * zl + gate * zn;
      const float qs = softplus_(sraw) + min_std;
      const float q2 = qs * qs + kEps;
      const float p2 = 1.f / q2;
      const float den2 = p1 + p2;
      const float num2 = gm * p1 + qm * p2;
      const float ppm = num2 / den2;
      const float pps = rsqrt_(den2);
      const float d_ppm = d_prior_m / (float)K + d_var * 2.f * (ppm - mu) / (float)K;
      const float d_pps = d_var * 2.f * pps / (float)K;
      const float d_num2 = d_ppm / den2;
      const float d_den2 = -d_ppm * num2 / (den2 * den2) - 0.5f * d_pps * pow_m15_(den2);
      const float d_qm = d_num2 * p2;
      const float d_p2 = d_num2 * qm + d_den2;
      const float d_qs = d_p2 * (-2.f * qs / (q2 * q2));
      dg[0] += d_num2 * p1;
      dg[1] += d_num2 * gm + d_den2;
      // GTF output VJP (elementwise part), over the pre-activations.
      y[la + 2 * D + d] = d_qs * sigmoid_(sraw);                  // d_sraw
      y[la + d] = d_qm * (zn - zl) * gate * (1.f - gate);         // d_a2
      y[2 * H + d] = d_qm * (1.f - gate);                         // d_zlin
      y[la + D + d] = d_qm * gate;                                // d_znon, partial
    }
    lane_sum(dg, ln.tpe);
    if (live && sub == 0) {
      a.d_glb_mean[bd] += dg[0];
      a.d_glb_std[bd] +=
          dg[1] * (-2.f * gs / ((gs * gs + kEps) * (gs * gs + kEps)));
    }
  }
}

__global__ void __launch_bounds__(kColThreads, 4)
    bfvi_scan_bwd_column_kernel(BwdArgs a, int cols) {
  extern __shared__ __align__(16) float csm[];
  const int D = a.s.D, H = a.s.H, K = a.s.K, B = a.s.B, T = a.s.T;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D, H2 = 2 * H;
  const ColCols cc(B, cols);
  const int rows = cc.g * K, cap = cols * K;
  const ColW w = col_weights(csm, D, H);
  float* region = csm + col_weight_floats(D, H);
  // The recompute's buffers, then the walk's in the same place.
  float* z = region;
  float* work = z + cap * D;
  float* X = region;
  float* Y = X + cap * lx;
  float* gz = Y + cap * ly;

  // The transition of every step t >= 1 of the CTA's rows, with the
  // forward's routine: xs = [h1 | hn | z_nonlin] and, in ys, z_lin, a2 and
  // s_raw (biases added) where the VJP writes d_zlin, d_a2 and d_sraw.
  col_load_weights(a.w, w, D, H, true);
  for (int t = 1; t < T; ++t) {
    for (int i = threadIdx.x; i < rows * D; i += kColThreads) {
      const int r = i / D, dd = i - r * D;
      z[i] = __ldg(a.z_traj + cc.row(t - 1, K, B, r) * D + dd);
    }
    __syncthreads();
    col_transition(w, rows, D, H, z, work, [&](int ph, int r, int n,
                                               float v) {
      const size_t row = cc.row(t - 1, K, B, r);
      float* xr = a.xs + row * lx;
      float* yr = a.ys + row * ly;
      if (ph == 0) {
        if (n < H2) xr[n] = v;  // h1, hn
        else yr[n] = v;         // z_lin
      } else if (ph == 1) {
        yr[la + n] = v;         // a2
      } else if (ph == 2) {
        xr[H2 + n] = v;         // z_nonlin
      } else {
        yr[la + 2 * D + n] = v;  // s_raw
      }
    });
  }

  // The walk in reverse, on the weights as they are.
  __syncthreads();
  col_load_weights(a.w, w, D, H, false);
  for (int i = threadIdx.x; i < rows * D; i += kColThreads) gz[i] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) {
      for (int i = threadIdx.x; i < rows * lx; i += kColThreads) {
        const int r = i / lx, c = i - r * lx;
        X[i] = a.xs[cc.row(t - 1, K, B, r) * lx + c];
      }
      for (int i = threadIdx.x; i < rows * ly; i += kColThreads) {
        const int r = i / ly, c = i - r * ly;
        Y[i] = a.ys[cc.row(t - 1, K, B, r) * ly + c];
      }
    }
    __syncthreads();
    col_bwd_elementwise(a, t, cc, X, Y, gz);
    __syncthreads();
    if (t == 0) break;
    // d_znon += d_sraw @ ws;  d_a1 = (d_a2 @ wg2) * (h1 > 0)
    col_product(rows, D, D, Y + la + 2 * D, ly, w.ws,
                [&](int r, int n, float acc) {
                  float* p = Y + r * ly + la + D + n;
                  *p = acc + *p;
                });
    col_product(rows, H, D, Y + la, ly, w.wg2, [&](int r, int n, float acc) {
      Y[r * ly + n] = acc * (X[r * lx + n] > 0.f ? 1.f : 0.f);
    });
    __syncthreads();
    // d_b1 = (d_znon @ wn2) * (hn > 0)
    col_product(rows, H, D, Y + la + D, ly, w.wn2,
                [&](int r, int n, float acc) {
                  Y[r * ly + H + n] = acc * (X[r * lx + H + n] > 0.f ? 1.f : 0.f);
                });
    __syncthreads();
    // The cotangent of z_{t-1}: [d_a1 | d_b1 | d_zlin] @ w1, one sum over
    // its 2H + D rows in order; and the step's ys rows out.
    col_product(rows, D, la, Y, ly, w.w1,
                [&](int r, int n, float acc) { gz[r * D + n] = acc; });
    for (int i = threadIdx.x; i < rows * ly; i += kColThreads) {
      const int r = i / ly, c = i - r * ly;
      a.ys[cc.row(t - 1, K, B, r) * ly + c] = Y[i];
    }
    __syncthreads();
  }
}

}  // namespace f32scan
}  // namespace
