// The BFVI filtering scan in bfloat16 (MultiDMM(bf16_gtf=True)), forward and
// backward, for Hopper (sm_90a): bfvi_scan_fwd_bf16_kernel and
// bfvi_scan_bwd_bf16_kernel, and the C entry points bfvi_scan_fwd and
// bfvi_scan_bwd of the bf16 library (bfvi_scan_bf16.cu, which includes
// bfvi_scan.cuh first for gtf_wgrad_bf16_kernel and the shared helpers).
//
// Replaces the Pallas TPU kernels of multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:
//   bfvi_scan_fwd_bf16_kernel <- bfvi_scan_pallas / _fwd_kernel (:118)
//   bfvi_scan_bwd_bf16_kernel <- bfvi_scan_pallas_bwd / _bwd_kernel (:293)
// on the JAX package's bf16_gtf path, with its rounding points (those of
// gtf_apply_packed and its VJP):
//   - every product's operands are bfloat16, and its float32 sum is rounded
//     to bfloat16 before the bias, the ReLU or an add;
//   - the cotangent of z_{t-1} is one product over the packed [gate_1;
//     nonlin_1; z_lin] (depth 2H + D), rounded once;
//   - the rows xs = [h1 | hn | z_nonlin], ys = [d_a1 | d_b1 | d_zlin | d_a2
//     | d_znonlin | d_sraw] and z that gtf_wgrad_bf16_kernel reads
//     (wgrad_bf16.cuh) are written in bfloat16, laid out as bfvi_scan.cuh
//     lays out its float32 rows: the images of the operands that JAX's
//     weight-gradient products take, so half the bytes and the same
//     products. The bias gradients sum the float32 cotangents in f32
//     accumulators of the CTA's own in global memory (bacc), each updated
//     by one thread in step order: for d_a1, d_b1 and d_znonlin one a tile
//     row and column, read ahead of the products that make the values; for
//     d_zlin, d_a2 and d_sraw one a batch column and d, to which the lanes
//     of an element add their particles' sum (a fixed butterfly). At the
//     end each CTA sums its accumulators column by column into its
//     cluster's partial (bias_part), which the weight gradients' reduction
//     adds in group order. No float atomics.
//
// What bounds a launch on the H100: latency, not work. One step of the
// Weizmann K = 25 forward (2,500 particle rows, D = H = 256) is 2 GFLOP,
// 2 us at 989 TFLOP/s; the launch is T - 1 dependent steps, each three
// dependent products, an elementwise phase and the exchanges between
// them. The design before this one ran each phase over the whole grid,
// with a grid barrier between phases, activations in float32 through L2
// and float32 operands rounded per element.
//
// Design. The scan is independent per batch column: only the weights are
// shared. So one thread block cluster of C CTAs (C <= 8, the portable size)
// owns a group of columns, all K particles of each (at most 64 rows, one
// wgmma M tile), for the whole time loop, and no barrier spans more than
// the cluster (the launch plan, ops/cuda/bfvi_scan.py: bf16_scan_plan).
//   - CTA j of a cluster owns the j-th slice of every output width: of H
//     (gate_1, nonlin_1) and of D (z_lin, gate_2, nonlin_2, z_to_std). Its
//     weight slices, packed by the wrapper as bfloat16 images already in
//     the 128-byte swizzle that wgmma reads (bf16_pack), are loaded once
//     per launch by one TMA bulk copy and stay in shared memory for all
//     steps ("resident"). Where they do not fit (D = H = 512), each 64-deep
//     slab of a chunk's weight rows is copied (cp.async) into a slot of
//     shared memory before its products ("streamed"), by the same routine.
//   - A product's A operand is the step's full activation (z, [h1 | hn],
//     z_nonlin; in the backward [d_a2 | d_sraw], d_znonlin and [d_a1 | d_b1
//     | d_zlin]), in bfloat16 in shared memory. Each CTA writes its slice
//     into its own copy, then into each peer's through distributed shared
//     memory (mapa + st.shared::cluster, 16 bytes a store), and one cluster
//     barrier later every CTA holds the whole operand.
//   - Products run on wgmma.mma_async m64nNk16 (N of 8-64 a chunk; one
//     job's columns are cut in two so that both warpgroups of the CTA work),
//     bf16 in, f32 accumulate, A and B from shared memory. The forward and
//     the backward's recompute run the same jobs through the same routine,
//     in the same order of 16-deep steps, so the recomputed activations are
//     the forward's bit for bit (the forward can write its own as rows to
//     check this).
//   - The elementwise phase of CTA j is local: the mixture over the K
//     particles of a column, the observation PoE and the sampling for its
//     D-slice, from the product outputs it keeps (rounded, before the bias,
//     in bfloat16: exact), four consecutive d a lane group (16-byte loads),
//     the K particles of one (b, d) on lanes of one warp that meet by
//     shuffles in a fixed order. Its divisions, square roots, exponentials
//     and logarithms are the approximate instructions (a few float32 ulp).
//   - The backward recomputes the transition for its columns over all T - 1
//     steps first (two cluster barriers a step), writing the xs/ys rows,
//     then loads the transposed weight slices and walks time in reverse:
//     the elementwise VJP, then d_znonlin and d_a1 (through ws, wg2), d_b1
//     (through wn2), the z cotangent (through w1), each CTA computing its
//     output slice over the full depth from gathered operands (four cluster
//     barriers a step). No split-K, no float atomics: two runs agree bit
//     for bit.
//
// Shared memory of a CTA (bytes; D = H = 256, C = 8, 56 rows: two columns
// of K = 25, or 56 of K = 1): weights 98,304; the forward's z, z_nonlin and
// [h1 | hn] 114,688 and its slices and biases; the backward's three
// operands share room ([d_a2 | d_sraw] lies in the columns of d_a1 and d_b1
// until those are written), 114,688: 229,376 either way, of the 232,448 a
// CTA may use. The card runs 15 such clusters at once.
//
// Layouts (one scan direction; the caller flips time): as bfvi_scan.cuh.
// D and H must be multiples of 16 and of 8 C; the wrapper zero-pads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bf16scan {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTileRows = 64;  // wgmma's M
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16 values
constexpr int kRingRows = 64;   // a streamed slot: a chunk's weight rows
constexpr int kMaxCluster = 8;

__host__ __device__ inline int nslab(int k) { return (k + 63) / 64; }
__host__ __device__ inline int up1k(int x) { return (x + 1023) & ~1023; }

// The weight matrices of one direction (B operands, N rows by K deep) and
// the activation buffers (A operands, rb rows by K deep), their byte
// offsets in a CTA's shared memory (from a 1,024-aligned base) and the
// whole size. Weight images in global memory have the resident layout.
struct Layout {
  int wn[4], wk[4], w[4];
  int wbytes;  // the four weight matrices
  int ring;    // streamed route: a slot of kRingRows rows a warpgroup
  int bk[3], buf[3];
  int loc;     // the CTA's own slices
  int bias;    // forward: the CTA's bias slices, f32
  int total;
};

// Forward (bwd = 0): weights [w1 slice (2 Hs + Ds rows) | wg2 | wn2 | ws
// slices (Ds rows)], buffers [z | z_nonlin | h1 hn]; the slices are
// z_lin, a2, z_nonlin and s_raw before their bias, bf16, rb x Ds each;
// the biases [b1 slice (2 Hs + Ds) | bg2 | bn2 | bs slices (Ds)].
// Backward (bwd = 1): weights [w1^T (Ds rows, 2H + D deep) | ws^T (Ds) |
// wg2^T (Hs) | wn2^T (Hs)], buffers [d_a2 d_sraw | d_znonlin | d_a1 d_b1
// d_zlin]; where D <= H the first shares the third's first 2 D columns
// (it is dead once d_a1 and d_b1 are written there, scan_bwd); the
// slices: the partial d_znonlin (f32, rb x Ds), the z cotangent (bf16: it
// is rounded there, rb x Ds) and d_a1 staged (bf16, rb x Hs).
__host__ __device__ inline Layout make_layout(int bwd, int D, int H, int C,
                                              int rb, int resident) {
  Layout L;
  const int Ds = D / C, Hs = H / C, LA = 2 * H + D;
  if (!bwd) {
    const int wn[4] = {2 * Hs + Ds, Ds, Ds, Ds}, wk[4] = {D, H, H, D};
    const int bk[3] = {D, D, 2 * H};
    for (int i = 0; i < 4; ++i) { L.wn[i] = wn[i]; L.wk[i] = wk[i]; }
    for (int i = 0; i < 3; ++i) L.bk[i] = bk[i];
  } else {
    const int wn[4] = {Ds, Ds, Hs, Hs}, wk[4] = {LA, D, D, D};
    const int bk[3] = {2 * D, D, LA};
    for (int i = 0; i < 4; ++i) { L.wn[i] = wn[i]; L.wk[i] = wk[i]; }
    for (int i = 0; i < 3; ++i) L.bk[i] = bk[i];
  }
  int off = 0;
  for (int i = 0; i < 4; ++i) {
    L.w[i] = off;
    off += nslab(L.wk[i]) * L.wn[i] * kRowBytes;
  }
  L.wbytes = off;
  if (!resident) off = 0;
  L.ring = off;
  if (!resident) off += 2 * kRingRows * kRowBytes;
  for (int i = 2; i >= 0; --i) {
    if (bwd && i == 0 && D <= H) {
      L.buf[0] = L.buf[2];
      continue;
    }
    L.buf[i] = off;
    off += nslab(L.bk[i]) * rb * kRowBytes;
  }
  L.loc = off;
  off += up1k(bwd ? rb * (Ds * 6 + Hs * 2) : 4 * rb * Ds * 2);
  // The last tile reads past rb rows, into the biases and beyond.
  L.bias = off;
  const int bias = bwd ? 0 : (2 * Hs + 4 * Ds) * 4;
  const int pad = (kTileRows - rb) * kRowBytes;
  off += bias > pad ? bias : pad;
  L.total = off + 1024;  // aligning the base
  return L;
}

// Floats of a CTA's bias-gradient accumulators (Args::bacc).
__host__ __device__ inline int bacc_floats(int rb, int cols, int Hs, int Ds) {
  return rb * (2 * Hs + Ds) + cols * 3 * Ds;
}

// A CTA's shared memory: the backward runs the forward's layout during its
// recompute and its own after.
__host__ __device__ inline int smem_bytes(int bwd, int D, int H, int C,
                                          int rb, int resident) {
  const int f = make_layout(0, D, H, C, rb, resident).total;
  if (!bwd) return f;
  const int b = make_layout(1, D, H, C, rb, resident).total;
  return f > b ? f : b;
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of element (r, c) in a K-major buffer of rb rows in the
// 128-byte swizzle: 64-column slabs of rb rows, 16-byte chunks XORed with
// the row within its 8-row group (the base is 1,024-aligned).
__device__ __forceinline__ int swz(int rb, int r, int c) {
  return (c >> 6) * rb * kRowBytes + r * kRowBytes +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1,024 bytes apart.
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int NC>
struct Mma;
// wgmma.mma_async m64nNCk16, bf16 x bf16 -> f32, A and B from shared
// memory (K-major, descriptors), accumulating into d.
#define BF16_SCAN_MMA(NC, REGS, OUTS)                                        \
  template <>                                                                \
  struct Mma<NC> {                                                           \
    __device__ static void run(float (&d)[NC / 2], uint64_t a, uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #REGS ", 0;\n"      \
                   "wgmma.mma_async.sync.aligned.m64n" #NC "k16.f32.bf16.bf16 " \
                   OUTS                                                      \
                   : BF16_SCAN_ACC##NC                                       \
                   : "l"(a), "l"(b), "r"(1));                                \
    }                                                                        \
  };

#define BF16_SCAN_ACC8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
BF16_SCAN_MMA(8, 6, "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n")
#define BF16_SCAN_ACC16 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
BF16_SCAN_MMA(16, 10, "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, \
    0, 0;\n}\n")
#define BF16_SCAN_ACC24 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11])
BF16_SCAN_MMA(24, 14, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, \
    %12, %13, p, 1, 1, 0, 0;\n}\n")
#define BF16_SCAN_ACC32 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15])
BF16_SCAN_MMA(32, 18, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, \
    %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n")
#define BF16_SCAN_ACC48 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
BF16_SCAN_MMA(48, 26, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, \
    %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, \
    p, 1, 1, 0, 0;\n}\n")
#define BF16_SCAN_ACC64 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])
BF16_SCAN_MMA(64, 34, "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, \
    %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, \
    %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n")
#undef BF16_SCAN_MMA

// Generic-proxy writes to shared memory (this CTA's or, with cluster, the
// peers') before an async-proxy read (wgmma, a bulk copy) of them.
__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The warpgroup's own barrier (named barrier 1 + wg over its 128 threads).
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ void put_bf2(char* sm, int off, float v0,
                                       float v1) {
  *reinterpret_cast<uint32_t*>(sm + off) = pack_bf2(v0, v1);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The launch's one-shot TMA bulk copy of `bytes` from global memory into
// this CTA's shared memory, completed on the mbarrier at `bar`; every
// thread waits for phase `parity`. A wait still open after 10 s traps, so
// a fault ends the launch with an error instead of hanging the device.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar,
                                          int parity) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    for (int o = 0; o < bytes;) {
      const int n = bytes - o < (1 << 20) ? bytes - o : (1 << 20);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          ::"r"(dst + o), "l"(reinterpret_cast<const char*>(src) + o),
          "r"(n), "r"(bar) : "memory");
      o += n;
    }
  }
  const unsigned long long t0 = now_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (now_ns() - t0 > 10000000000ull) __trap();
  }
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// One product of a phase: the A operand (buffer `a` of the layout, its
// columns [a_col, a_col + K)) times weight matrix `m` (all its N rows),
// the output delivered by tag.
struct Job {
  int a, a_col, K, m, N, tag;
};

struct Ctx {
  char* sm;           // the aligned base
  uint32_t sm_addr;   // its shared-space address
  Layout L;
  int rb, resident;
  const char* wimg;   // this CTA's weight image (global)
};

// acc = A[:, a_col:a_col+K] @ W_m[n0:n0+NC, :]^T on this warpgroup, then
// epi(tag, row, col, v0, v1) for every pair (col even) of the 64 x NC
// tile. Resident: every 16-deep step reads the weights in place, one
// commit. Streamed: each 64-deep slab of the NC weight rows is copied
// into the warpgroup's ring slot first. The same steps in the same order
// either way.
// A value that every thread of the warp holds, so marked for the compiler
// (a broadcast from lane 0): wgmma chains whose trip counts and branches
// it cannot prove uniform are serialized.
__device__ __forceinline__ int uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

template <int NC, class Pre, class Epi>
__device__ __forceinline__ void chunk(const Ctx& cx, const Job& jb, int n0,
                                      int wg, Pre& pre, Epi& epi) {
  // Everything the loops use, in registers first: the fences' memory
  // clobbers would reload anything read through a reference.
  const int tag = jb.tag, a_col = jb.a_col, rb = cx.rb;
  const int ks = uniform(jb.K / 16), bn = cx.L.wn[jb.m];
  const uint32_t a_base = cx.sm_addr + cx.L.buf[jb.a];
  const int resident = uniform(cx.resident);
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  // What the epilogue reads from global memory, loaded now so that it
  // arrives while the products run.
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int r0 = 16 * warp + (lane >> 2);
  decltype(pre(0, 0, 0)) pv[NC / 4];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    pv[2 * j] = pre(tag, r0, col);
    pv[2 * j + 1] = pre(tag, r0 + 8, col);
  }
  auto a_desc = [=](int s) {
    const int col = a_col + 16 * s;
    return desc(a_base + (col >> 6) * rb * kRowBytes + (col & 63) * 2);
  };
  if (resident) {
    const uint32_t b_base = cx.sm_addr + cx.L.w[jb.m] + n0 * kRowBytes;
    auto b_desc = [=](int s) {
      const int kb = 16 * s;
      return desc(b_base + (kb >> 6) * bn * kRowBytes + (kb & 63) * 2);
    };
    // Groups of four 16-deep steps (one 64-deep slab), each group a fence,
    // four wgmma and a commit, the last wait after all.
    fence_regs(acc);
    const int full = ks & ~3;
    for (int s = 0; s < full; s += 4) {
      wg_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) Mma<NC>::run(acc, a_desc(s + i), b_desc(s + i));
      wg_commit();
    }
    for (int s = full; s < ks; ++s) {
      wg_fence();
      Mma<NC>::run(acc, a_desc(s), b_desc(s));
      wg_commit();
    }
    wg_wait0();
    fence_regs(acc);
  } else {
    const uint32_t slot = cx.sm_addr + cx.L.ring + wg * kRingRows * kRowBytes;
    const char* wsrc = cx.wimg + cx.L.w[jb.m] + n0 * kRowBytes;
    const int tid = threadIdx.x & 127;
    const int n_slabs = uniform(nslab(jb.K));
    for (int sl = 0; sl < n_slabs; ++sl) {
      wg_bar(wg);  // the slot's last reader is done
      const char* src = wsrc + sl * bn * kRowBytes;
      for (int i = tid; i < NC * kRowBytes / 16; i += 128) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     ::"r"(slot + 16 * i), "l"(src + 16 * i) : "memory");
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      fence_async_cta();
      wg_bar(wg);
      fence_regs(acc);
      wg_fence();
      for (int s4 = 0; s4 < 4 && sl * 4 + s4 < ks; ++s4)
        Mma<NC>::run(acc, a_desc(sl * 4 + s4), desc(slot + s4 * 32));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
    }
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    epi(tag, r0, col, acc[4 * j], acc[4 * j + 1], pv[2 * j]);
    epi(tag, r0 + 8, col, acc[4 * j + 2], acc[4 * j + 3], pv[2 * j + 1]);
  }
}

// The epilogue of a phase that reads nothing ahead.
struct NoPre {
  __device__ float2 operator()(int, int, int) const {
    return make_float2(0.f, 0.f);
  }
};

// The widths of a job's chunks: a phase of one job cuts it in two, so
// that both warpgroups work, and no chunk is wider than 64 columns; each
// width is one of wgmma's that Mma has (8, 16, 24, 32, 48, 64).
__device__ __forceinline__ int chunk_width(int target, int left) {
  const int w = target < left ? target : left;
  return w >= 64 ? 64 : w >= 48 ? 48 : w >= 32 ? 32 : w >= 24 ? 24
                                                    : w >= 16 ? 16 : 8;
}

// The jobs of one phase, cut into chunks that the two warpgroups take in
// turn. epi(tag, row, col, v0, v1, p) gets the pair (col even) of a tile
// and what pre(tag, row, col) loaded for it before the products.
template <class Epi, class Pre = NoPre>
__device__ __forceinline__ void run_phase(const Ctx& cx, const Job* jobs,
                                          int nj, Epi epi, Pre pre = Pre()) {
  const int wg = uniform(threadIdx.x >> 7);
  int c = 0;
  for (int j = 0; j < nj; ++j) {
    const int N = uniform(jobs[j].N);
    int parts = (N + 63) / 64;
    if (nj == 1 && parts < 2 && N >= 16) parts = 2;
    const int target = ((N + parts - 1) / parts + 7) & ~7;
    for (int n0 = 0; n0 < N;) {
      const int nc = chunk_width(target, N - n0);
      if ((c++ & 1) == wg) {
        switch (nc) {
          case 64: chunk<64>(cx, jobs[j], n0, wg, pre, epi); break;
          case 48: chunk<48>(cx, jobs[j], n0, wg, pre, epi); break;
          case 32: chunk<32>(cx, jobs[j], n0, wg, pre, epi); break;
          case 24: chunk<24>(cx, jobs[j], n0, wg, pre, epi); break;
          case 16: chunk<16>(cx, jobs[j], n0, wg, pre, epi); break;
          default: chunk<8>(cx, jobs[j], n0, wg, pre, epi); break;
        }
      }
      n0 += nc;
    }
  }
}

// Copies this CTA's columns [col, col + ncols) of buffer `b` (the first
// `rows` rows) from its own shared memory to the same place in each peer's.
__device__ void push_cols(const Ctx& cx, int b, int rows, int col, int ncols,
                          int C, int rank) {
  const int per_row = ncols / 8;
  const int n = rows * per_row;
  const int base = cx.L.buf[b], rb = cx.rb;
  const char* sm = cx.sm;
  const uint32_t sm_addr = cx.sm_addr;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / per_row, c = col + 8 * (i - r * per_row);
    const int off = base + swz(rb, r, c);
    const uint4 v = *reinterpret_cast<const uint4*>(sm + off);
    const uint32_t local = sm_addr + off;
    for (int p = 1; p < C; ++p) {
      const uint32_t peer = (rank + p) % C;
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote) : "r"(local), "r"(peer));
      asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// Copies a row-major bf16 staging of the CTA's columns [col, col +
// ncols) into buffer `b` of this CTA and of each peer.
__device__ void push_stage(const Ctx& cx, const char* stage, int b, int rows,
                           int col, int ncols, int C, int rank) {
  const int per_row = ncols / 8;
  const int n = rows * per_row;
  const int base = cx.L.buf[b], rb = cx.rb;
  char* sm = cx.sm;
  const uint32_t sm_addr = cx.sm_addr;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / per_row, q = i - r * per_row;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + (r * ncols + 8 * q) * 2);
    const int off = base + swz(rb, r, col + 8 * q);
    *reinterpret_cast<uint4*>(sm + off) = v;
    const uint32_t local = sm_addr + off;
    for (int p = 1; p < C; ++p) {
      const uint32_t peer = (rank + p) % C;
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote) : "r"(local), "r"(peer));
      asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// The end of a phase whose outputs the peers read: every thread's writes
// ordered before the peers' wgmma, then the cluster barrier.
__device__ __forceinline__ void publish() {
  fence_async_cluster();
  cluster_sync();
}

// ---------------------------------------------------------------------------
// Arguments, the elementwise lanes
// ---------------------------------------------------------------------------

struct Args {
  const float *obs_mean, *obs_std, *obs_mask, *glb_mean, *glb_std, *eps;
  const float *b1, *bg2, *bn2, *bs;
  const char* wimg;  // C images of img_bytes: the direction's weight slices
  int img_bytes;
  // forward
  float *prior_mean, *prior_std, *infer_mean, *infer_std, *samples, *z_traj;
  float* fwd_rows;  // null, or (T-1) K B rows [h1 | hn | z_nonlin]
  // backward
  const float *z_in, *prior_mean_in, *prior_std_in;
  const float *g_pm, *g_ps, *g_im, *g_is, *g_smp;
  float *d_obs_mean, *d_obs_std, *d_glb_mean, *d_glb_std;
  // f32 ys: the recompute's z_lin, a2, z_nonlin (in d_znonlin's columns)
  // and s_raw, with their biases, for the elementwise VJP; xs is not read.
  float *xs, *ys;
  uint16_t *xs_bf, *ys_bf, *zs_bf;  // the rows of the weight gradients, bf16
  // Per CTA, the bias gradients' f32 accumulators: rb x (2 Hs + Ds) for
  // [d_a1 | d_b1 | d_znonlin] a tile row, then cols x 3 x Ds for [d_zlin |
  // d_a2 | d_sraw] a batch column (bacc_floats).
  float* bacc;
  float* bias_part;  // per cluster: the 2H + 4D bias gradients' sums
  const char* wimg_fwd;  // backward: the forward images, for the recompute
  int img_bytes_fwd;
  int T, M, B, K, D, H;
  float min_std;
  int cols, C, rb, resident, smem;
};

// The cluster's columns [c0, c0 + g) and D-slice [d0, d0 + Ds): element e
// = (column cl, dd) of the slice has `tpe` lanes of one warp, which split
// its K particles (k = sub, sub + tpe, ...) and sum them by shuffles.
struct Lanes {
  int tpe, per_pass, n_el;
  __device__ Lanes(int n, int K) : n_el(n) {
    tpe = 1;
    while (tpe < 32 && tpe < K && n * tpe * 2 <= kThreads) tpe *= 2;
    per_pass = kThreads / tpe;
  }
};

template <int N>
__device__ __forceinline__ void lane_sum(float (&v)[N], int tpe) {
  // A butterfly: at each level a lane and its partner add the same two
  // values, so every lane of the group ends with the same bits.
  for (int o = 1; o < tpe; o <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

struct Cluster {
  int rank, c0, g, rows, d0, h0, Ds, Hs;
  __device__ Cluster(const Args& a) {
    rank = (int)cluster_rank();
    c0 = (blockIdx.x / a.C) * a.cols;
    g = min(a.cols, a.B - c0);
    rows = g * a.K;
    Ds = a.D / a.C;
    Hs = a.H / a.C;
    d0 = rank * Ds;
    h0 = rank * Hs;
  }
  // The xs/ys row of tile row `row` at step t >= 1.
  __device__ size_t xrow(const Args& a, int t, int row) const {
    const int cl = row / a.K, k = row - cl * a.K;
    return ((size_t)(t - 1) * a.K + k) * a.B + c0 + cl;
  }
};

__device__ void setup(Ctx& cx, const Args& a, int bwd, char* raw) {
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t pad = ((raw_addr + 1023u) & ~1023u) - raw_addr;
  cx.sm = raw + pad;
  cx.sm_addr = raw_addr + pad;
  cx.rb = a.rb;
  cx.resident = a.resident;
  cx.L = make_layout(bwd, a.D, a.H, a.C, a.rb, a.resident);
}

// The forward layout's bias slices: [b1 at the CTA's gate_1, nonlin_1
// and z_lin slices | bg2 | bn2 | bs at its D-slice], in the order of the
// products' output columns.
__device__ void load_bias(const Args& a, const Ctx& cx, const Cluster& cl) {
  float* bias = reinterpret_cast<float*>(cx.sm + cx.L.bias);
  const int Hs = cl.Hs, Ds = cl.Ds;
  for (int i = threadIdx.x; i < 2 * Hs + 4 * Ds; i += kThreads) {
    float v;
    if (i < Hs)
      v = a.b1[cl.h0 + i];
    else if (i < 2 * Hs)
      v = a.b1[a.H + cl.h0 + i - Hs];
    else if (i < 2 * Hs + Ds)
      v = a.b1[2 * a.H + cl.d0 + i - 2 * Hs];
    else if (i < 2 * Hs + 2 * Ds)
      v = a.bg2[cl.d0 + i - 2 * Hs - Ds];
    else if (i < 2 * Hs + 3 * Ds)
      v = a.bn2[cl.d0 + i - 2 * Hs - 2 * Ds];
    else
      v = a.bs[cl.d0 + i - 2 * Hs - 3 * Ds];
    bias[i] = v;
  }
}

// The forward's first three products of step t on the z rows in buffer 0;
// the backward's recompute runs the same jobs.
__device__ __forceinline__ void transition_jobs(const Args& a, const Cluster& cl,
                                                Job* p1, Job* p2, Job* p3) {
  p1[0] = Job{0, 0, a.D, 0, 2 * cl.Hs + cl.Ds, 0};
  p2[0] = Job{2, 0, a.H, 1, cl.Ds, 1};
  p2[1] = Job{2, a.H, a.H, 2, cl.Ds, 2};
  p3[0] = Job{1, 0, a.D, 3, cl.Ds, 3};
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Four consecutive d of one row, in registers.
struct F4 {
  float v[4];
};
__device__ __forceinline__ F4 ld4(const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  return F4{{u.x, u.y, u.z, u.w}};
}
__device__ __forceinline__ F4 ldg4(const float* p) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  return F4{{u.x, u.y, u.z, u.w}};
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// Four bf16 values (8 bytes) of shared memory as floats, and back.
__device__ __forceinline__ F4 bf4_at(const char* sm, int off) {
  const uint2 w = *reinterpret_cast<const uint2*>(sm + off);
  return F4{{__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
             __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u)}};
}
__device__ __forceinline__ void put_bf4(char* sm, int off, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(sm + off) =
      make_uint2(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]));
}
// Four values rounded to bfloat16 into a row in global memory.
__device__ __forceinline__ void st_bf4(uint16_t* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]));
}
// An accumulator of the bias gradients' sums, += v[0..3] (its thread's own).
__device__ __forceinline__ void add4(float* p, const float* v) {
  float4 o = *reinterpret_cast<const float4*>(p);
  o.x += v[0];
  o.y += v[1];
  o.z += v[2];
  o.w += v[3];
  *reinterpret_cast<float4*>(p) = o;
}
// What a backward epilogue reads ahead of its products: a pair's bias
// accumulators and, for d_a1 and d_b1, the pair's ReLU mask (h1 or hn
// there in bf16: > 0 where the f32 value is).
struct Ahead {
  float2 acc;
  uint32_t mask;
};
__device__ __forceinline__ float on0(uint32_t m) {
  return __uint_as_float(m << 16) > 0.f ? 1.f : 0.f;
}
__device__ __forceinline__ float on1(uint32_t m) {
  return __uint_as_float(m & 0xffff0000u) > 0.f ? 1.f : 0.f;
}

// The masked, signed-precision observation experts of (t, b, d..d+3),
// added to the PoE sums: the loads of BATCH experts issued before any is
// used, so that the forward (BATCH 4) pays one round trip to memory for
// M <= 4, not M; the backward, whose registers are full, takes one at a
// time.
template <int BATCH>
__device__ __forceinline__ void obs_sums4(const Args& a, int t, int b, int d,
                                          float (&num)[4], float (&den)[4]) {
  for (int m0 = 0; m0 < a.M; m0 += BATCH) {
    float mk[BATCH];
    F4 os[BATCH], om[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (m0 + j < a.M) {
        const size_t tm = (size_t)t * a.M + m0 + j;
        const size_t o = (tm * a.B + b) * a.D + d;
        mk[j] = __ldg(a.obs_mask + tm * a.B + b);
        os[j] = ldg4(a.obs_std + o);
        om[j] = ldg4(a.obs_mean + o);
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (m0 + j < a.M && mk[j] > 0.f) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float prec =
              sign_(os[j].v[i]) / (os[j].v[i] * os[j].v[i] + kEps);
          num[i] += om[j].v[i] * prec;
          den[i] += prec;
        }
      }
    }
  }
}

// Particles of a lane whose inputs it loads before anything else.
constexpr int kPre = 2;

// bfvi_scan.cuh's sigmoid, softplus and per-particle PoE on the
// approximate exponential and logarithm (a few float32 ulp, far below the
// bfloat16 rounding of the products they follow).
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float softp(float x) {
  return fmaxf(x, 0.f) + __logf(1.f + __expf(-fabsf(x)));
}
__device__ __forceinline__ void poe2f(float gm, float p1, float a2, float zl,
                                      float zn, float sraw, float min_std,
                                      float& ppm, float& pps) {
  const float gate = sigm(a2);
  const float qm = (1.f - gate) * zl + gate * zn;
  const float qs = softp(sraw) + min_std;
  const float p2 = 1.f / (qs * qs + kEps);
  const float den2 = p1 + p2;
  ppm = (gm * p1 + qm * p2) / den2;
  pps = rsqrtf(den2);
}

// Step t's elementwise phase for the CTA's D-slice: each lane group owns
// four consecutive d of one column (16-byte loads and stores) and splits
// its K particles.
__device__ void fwd_elementwise(const Args& a, const Ctx& cx, const Cluster& cl,
                                int t) {
  // The fields used in the loops, in registers (the loops store through
  // pointers that could alias a reference).
  const int D = a.D, K = a.K, Ds = cl.Ds, Q = Ds / 4, rb = a.rb;
  const int c_first = cl.c0, d_first = cl.d0;
  char* const sm = cx.sm;
  const int zbuf = cx.L.buf[0];
  const Lanes ln(cl.g * Q, K);
  const char* sl = sm + cx.L.loc;  // [z_lin | a2 | z_nonlin | s_raw]
  const float* bias = reinterpret_cast<const float*>(sm + cx.L.bias);
  const int sl_stride = rb * Ds * 2, nb = 2 * cl.Hs;
  for (int base = 0; base < ln.n_el; base += ln.per_pass) {
    const int e = base + threadIdx.x / ln.tpe, sub = threadIdx.x % ln.tpe;
    const bool live = e < ln.n_el;
    const int c = live ? e / Q : 0, dd = live ? 4 * (e - c * Q) : 0;
    const int b = c_first + c, d = d_first + dd;
    const size_t bd = (size_t)b * D + d;
    F4 ep[kPre];
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int k = sub + j * ln.tpe;
      if (live && k < K) ep[j] = ldg4(a.eps + (((size_t)t * K + k) * a.B + b) * D + d);
    }
    F4 gm = {{0.f, 0.f, 0.f, 0.f}}, gs = {{1.f, 1.f, 1.f, 1.f}};
    float num_o[4] = {0.f, 0.f, 0.f, 0.f}, den_o[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      gm = ldg4(a.glb_mean + bd);
      gs = ldg4(a.glb_std + bd);
      obs_sums4<4>(a, t, b, d, num_o, den_o);
    }
    float pm[4], ps[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pm[i] = gm.v[i];
      ps[i] = gs.v[i];
    }
    if (t > 0) {
      // PoE(global prior, GTF(z_k)) per particle, then the moment-matched
      // mixture over the K particles.
      float p1[4], m3[12];
#pragma unroll
      for (int i = 0; i < 4; ++i) p1[i] = 1.f / (gs.v[i] * gs.v[i] + kEps);
#pragma unroll
      for (int i = 0; i < 12; ++i) m3[i] = 0.f;
      if (live) {
        const F4 bz = ld4(bias + nb + dd), bg = ld4(bias + nb + Ds + dd);
        const F4 bn = ld4(bias + nb + 2 * Ds + dd);
        const F4 bs = ld4(bias + nb + 3 * Ds + dd);
        for (int k = sub; k < K; k += ln.tpe) {
          const int o = ((c * K + k) * Ds + dd) * 2;
          const F4 zl = bf4_at(sl, o), a2 = bf4_at(sl, sl_stride + o);
          const F4 zn = bf4_at(sl, 2 * sl_stride + o);
          const F4 sr = bf4_at(sl, 3 * sl_stride + o);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float ppm, pps;
            poe2f(gm.v[i], p1[i], a2.v[i] + bg.v[i], zl.v[i] + bz.v[i],
                 zn.v[i] + bn.v[i], sr.v[i] + bs.v[i], a.min_std, ppm, pps);
            m3[i] += ppm;
            m3[4 + i] += pps * pps;
            m3[8 + i] += ppm * ppm;
          }
        }
      }
      lane_sum(m3, ln.tpe);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mu = m3[i] / (float)K;
        const float var = m3[4 + i] / (float)K + m3[8 + i] / (float)K - mu * mu;
        pm[i] = mu;
        ps[i] = sqrtf(fmaxf(var, 0.f));
      }
    }
    // Masked, signed-precision PoE with the M observation experts.
    float im[4], is[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float prec_p = 1.f / (ps[i] * ps[i] + kEps);
      const float num = pm[i] * prec_p + num_o[i], den = prec_p + den_o[i];
      const bool low = den < kPrecFloor;
      const float safe = low ? 1.f : den;
      im[i] = low ? 0.f : num / safe;
      is[i] = low ? 1e3f : rsqrt_(safe);
    }
    const size_t tbd = ((size_t)t * a.B + b) * D + d;
    if (live && sub == 0) {
      st4(a.prior_mean + tbd, pm);
      st4(a.prior_std + tbd, ps);
      st4(a.infer_mean + tbd, im);
      st4(a.infer_std + tbd, is);
    }
    float zs[4] = {0.f, 0.f, 0.f, 0.f};
    auto sample = [&](int k, const F4& e4) {
      const size_t o = (((size_t)t * K + k) * a.B + b) * D + d;
      float z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z[i] = im[i] + e4.v[i] * is[i];
        zs[i] += z[i];
      }
      st4(a.z_traj + o, z);
      put_bf4(sm, zbuf + swz(rb, c * K + k, d), z);
    };
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int k = sub + j * ln.tpe;
      if (live && k < K) sample(k, ep[j]);
    }
    for (int k = sub + kPre * ln.tpe; live && k < K; k += ln.tpe)
      sample(k, ldg4(a.eps + (((size_t)t * K + k) * a.B + b) * D + d));
    lane_sum(zs, ln.tpe);
    if (live && sub == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) zs[i] /= (float)K;
      st4(a.samples + tbd, zs);
    }
  }
}

__device__ void scan_fwd(const Args& a) {
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) unsigned long long wbar;
  Ctx cx;
  setup(cx, a, 0, raw);
  const Cluster cl(a);
  cx.wimg = a.wimg + (size_t)cl.rank * a.img_bytes;
  const int D = a.D, H = a.H, Ds = cl.Ds, Hs = cl.Hs;
  const int lx = 2 * H + D;
  const uint32_t bar = smem_u32(&wbar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (a.resident) bulk_load(cx.sm_addr, cx.wimg, cx.L.wbytes, bar, 0);
  load_bias(a, cx, cl);
  cluster_sync();  // every peer runs before any shared memory is written

  Job p1[1], p2[2], p3[1];
  transition_jobs(a, cl, p1, p2, p3);
  const float* bias = reinterpret_cast<const float*>(cx.sm + cx.L.bias);
  char* sl = cx.sm + cx.L.loc;
  const int sl_stride = a.rb * Ds * 2;
  const int rows = cl.rows;
  for (int t = 0; t < a.T; ++t) {
    if (t > 0) {
      run_phase(cx, p1, 1, [=, &a](int, int row, int n, float v0, float v1, float2 pv) {
        if (row >= rows) return;
        v0 = round_bf(v0);
        v1 = round_bf(v1);
        if (n < 2 * Hs) {  // h1 (n < Hs) or hn: ReLU after the bias
          const int col = n < Hs ? cl.h0 + n : H + cl.h0 + (n - Hs);
          v0 = fmaxf(v0 + bias[n], 0.f);
          v1 = fmaxf(v1 + bias[n + 1], 0.f);
          put_bf2(cx.sm, cx.L.buf[2] + swz(a.rb, row, col), v0, v1);
          if (a.fwd_rows) {
            float* xr = a.fwd_rows + cl.xrow(a, t, row) * lx + col;
            xr[0] = v0;
            xr[1] = v1;
          }
        } else {  // z_lin, before its bias
          put_bf2(sl, (row * Ds + n - 2 * Hs) * 2, v0, v1);
        }
      });
      __syncthreads();
      push_cols(cx, 2, rows, cl.h0, Hs, a.C, cl.rank);
      push_cols(cx, 2, rows, H + cl.h0, Hs, a.C, cl.rank);
      publish();
      run_phase(cx, p2, 2, [=, &a](int tag, int row, int n, float v0, float v1, float2 pv) {
        if (row >= rows) return;
        v0 = round_bf(v0);
        v1 = round_bf(v1);
        const int o = (row * Ds + n) * 2;
        if (tag == 1) {  // gate_2's pre-activation a2, before its bias
          put_bf2(sl, sl_stride + o, v0, v1);
          return;
        }
        put_bf2(sl, 2 * sl_stride + o, v0, v1);  // z_nonlin before its bias
        const int d = cl.d0 + n;
        v0 += bias[2 * Hs + 2 * Ds + n];
        v1 += bias[2 * Hs + 2 * Ds + n + 1];
        put_bf2(cx.sm, cx.L.buf[1] + swz(a.rb, row, d), v0, v1);
        if (a.fwd_rows) {
          float* xr = a.fwd_rows + cl.xrow(a, t, row) * lx + 2 * H + d;
          xr[0] = v0;
          xr[1] = v1;
        }
      });
      __syncthreads();
      push_cols(cx, 1, rows, cl.d0, Ds, a.C, cl.rank);
      publish();
      run_phase(cx, p3, 1, [=, &a](int, int row, int n, float v0, float v1, float2 pv) {
        if (row < rows) put_bf2(sl, 3 * sl_stride + (row * Ds + n) * 2,
                                round_bf(v0), round_bf(v1));
      });
      __syncthreads();
    }
    fwd_elementwise(a, cx, cl, t);
    __syncthreads();
    if (t + 1 < a.T) push_cols(cx, 0, rows, cl.d0, Ds, a.C, cl.rank);
    publish();  // also keeps every CTA resident until its peers are done
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The transition of every step t >= 1 for the cluster's columns, from
// z_traj, with the forward's jobs: xs = [h1 | hn | z_nonlin] and, in ys,
// z_lin, a2 and s_raw (their bias added) where the VJP later writes d_zlin,
// d_a2 and d_sraw.
__device__ void recompute(const Args& a, const Ctx& cx, const Cluster& cl) {
  const int D = a.D, H = a.H, Ds = cl.Ds, Hs = cl.Hs, K = a.K;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D;
  Job p1[1], p2[2], p3[1];
  transition_jobs(a, cl, p1, p2, p3);
  const float* bias = reinterpret_cast<const float*>(cx.sm + cx.L.bias);
  const int rows = cl.rows, c_first = cl.c0, rb = a.rb;
  char* const zbuf = cx.sm + cx.L.buf[0];
  for (int t = 1; t < a.T; ++t) {
    // z_{t-1} of the cluster's rows, all D columns, into buffer 0.
    const int per_row = D / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int row = i / per_row, c = 8 * (i - row * per_row);
      const int clm = row / K, k = row - clm * K;
      const float4* src = reinterpret_cast<const float4*>(
          a.z_in + (((size_t)(t - 1) * K + k) * a.B + c_first + clm) * D + c);
      const float4 u = __ldg(src), v = __ldg(src + 1);
      uint4 w;
      w.x = pack_bf2(u.x, u.y);
      w.y = pack_bf2(u.z, u.w);
      w.z = pack_bf2(v.x, v.y);
      w.w = pack_bf2(v.z, v.w);
      *reinterpret_cast<uint4*>(zbuf + swz(rb, row, c)) = w;
      if (c >= cl.d0 && c < cl.d0 + Ds)  // the CTA's slice of the z rows
        *reinterpret_cast<uint4*>(a.zs_bf + cl.xrow(a, t, row) * D + c) = w;
    }
    fence_async_cta();
    __syncthreads();
    run_phase(cx, p1, 1, [=, &a](int, int row, int n, float v0, float v1, float2 pv) {
      if (row >= rows) return;
      v0 = round_bf(v0);
      v1 = round_bf(v1);
      const size_t r = cl.xrow(a, t, row);
      if (n < 2 * Hs) {
        const int col = n < Hs ? cl.h0 + n : H + cl.h0 + (n - Hs);
        v0 = fmaxf(v0 + bias[n], 0.f);
        v1 = fmaxf(v1 + bias[n + 1], 0.f);
        put_bf2(cx.sm, cx.L.buf[2] + swz(a.rb, row, col), v0, v1);
        *reinterpret_cast<uint32_t*>(a.xs_bf + r * lx + col) = pack_bf2(v0, v1);
      } else {
        const int d = cl.d0 + n - 2 * Hs;
        *reinterpret_cast<float2*>(a.ys + r * ly + 2 * H + d) = make_float2(
            v0 + bias[n], v1 + bias[n + 1]);
      }
    });
    __syncthreads();
    push_cols(cx, 2, rows, cl.h0, Hs, a.C, cl.rank);
    push_cols(cx, 2, rows, H + cl.h0, Hs, a.C, cl.rank);
    publish();
    run_phase(cx, p2, 2, [=, &a](int tag, int row, int n, float v0, float v1, float2 pv) {
      if (row >= rows) return;
      const int d = cl.d0 + n;
      const size_t r = cl.xrow(a, t, row);
      v0 = round_bf(v0);
      v1 = round_bf(v1);
      if (tag == 1) {
        *reinterpret_cast<float2*>(a.ys + r * ly + la + d) = make_float2(
            v0 + bias[2 * Hs + Ds + n], v1 + bias[2 * Hs + Ds + n + 1]);
        return;
      }
      v0 += bias[2 * Hs + 2 * Ds + n];
      v1 += bias[2 * Hs + 2 * Ds + n + 1];
      put_bf2(cx.sm, cx.L.buf[1] + swz(a.rb, row, d), v0, v1);
      *reinterpret_cast<float2*>(a.ys + r * ly + la + D + d) = make_float2(v0, v1);
      *reinterpret_cast<uint32_t*>(a.xs_bf + r * lx + 2 * H + d) =
          pack_bf2(v0, v1);
    });
    __syncthreads();
    push_cols(cx, 1, rows, cl.d0, Ds, a.C, cl.rank);
    publish();
    run_phase(cx, p3, 1, [=, &a](int, int row, int n, float v0, float v1, float2 pv) {
      if (row >= rows) return;
      const int d = cl.d0 + n;
      *reinterpret_cast<float2*>(a.ys + cl.xrow(a, t, row) * ly + la + 2 * D + d) =
          make_float2(round_bf(v0) + bias[2 * Hs + 3 * Ds + n],
                      round_bf(v1) + bias[2 * Hs + 3 * Ds + n + 1]);
    });
    __syncthreads();
  }
}

// Step t's elementwise VJP for the CTA's D-slice, four consecutive d a
// lane group, as fwd_elementwise.
// (Not inlined: the products around it keep registers of their own.)
__device__ __noinline__ void bwd_elementwise(const Args& a, const Ctx& cx,
                                             const Cluster& cl, int t) {
  // The fields used in the loops, in registers (as fwd_elementwise).
  const int D = a.D, H = a.H, K = a.K, M = a.M, Ds = cl.Ds, Q = Ds / 4;
  const int la = 2 * H + D, ly = la + 3 * D, rb = a.rb;
  const int c_first = cl.c0, d_first = cl.d0, B = a.B;
  // The CTA's accumulators of [d_zlin | d_a2 | d_sraw] a batch column.
  float* const bacc = a.bacc + (size_t)blockIdx.x *
      bacc_floats(rb, a.cols, cl.Hs, Ds) + rb * (2 * cl.Hs + Ds);
  const size_t t_rows = (size_t)(t - 1) * K;  // the step's first xs/ys row / B
  char* const sm = cx.sm;
  const int dfbuf = cx.L.buf[0], g7buf = cx.L.buf[2];
  const Lanes ln(cl.g * Q, K);
  float* zp = reinterpret_cast<float*>(sm + cx.L.loc);
  const char* gzb = sm + cx.L.loc + rb * Ds * 4;
  for (int base = 0; base < ln.n_el; base += ln.per_pass) {
    const int e = base + threadIdx.x / ln.tpe, sub = threadIdx.x % ln.tpe;
    const bool live = e < ln.n_el;
    const int c = live ? e / Q : 0, dd = live ? 4 * (e - c * Q) : 0;
    const int b = c_first + c, d = d_first + dd;
    const size_t bd = (size_t)b * D + d;
    const size_t tbd = ((size_t)t * a.B + b) * D + d;
    // The loads first: the recomputed rows (L2) and the noise of the
    // lane's first particles, then the step's inputs.
    F4 pa2[kPre], pzl[kPre], pzn[kPre], psr[kPre], pep[kPre];
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int k = sub + j * ln.tpe;
      if (live && k < K) {
        pep[j] = ldg4(a.eps + (((size_t)t * K + k) * a.B + b) * D + d);
        if (t > 0) {
          const size_t r = (t_rows + k) * B + b;
          const float* y = a.ys + r * ly;
          pa2[j] = ld4(y + la + d);
          pzl[j] = ld4(y + 2 * H + d);
          pzn[j] = ld4(y + la + D + d);
          psr[j] = ld4(y + la + 2 * D + d);
        }
      }
    }
    F4 prior_m = {{0.f, 0.f, 0.f, 0.f}}, prior_s = {{1.f, 1.f, 1.f, 1.f}};
    F4 g_smp = prior_m, g_im = prior_m, g_is = prior_m, g_pm = prior_m;
    F4 g_ps = prior_m, gm = prior_m, gs = prior_s;
    float num_o[4] = {0.f, 0.f, 0.f, 0.f}, den_o[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      prior_m = ldg4(a.prior_mean_in + tbd);
      prior_s = ldg4(a.prior_std_in + tbd);
      g_smp = ldg4(a.g_smp + tbd);
      g_im = ldg4(a.g_im + tbd);
      g_is = ldg4(a.g_is + tbd);
      g_pm = ldg4(a.g_pm + tbd);
      g_ps = ldg4(a.g_ps + tbd);
      gm = ldg4(a.glb_mean + bd);
      gs = ldg4(a.glb_std + bd);
      obs_sums4<1>(a, t, b, d, num_o, den_o);
    }
    // Cotangents into z_t -> inference mean/std; a particle's cotangent is
    // the z cotangent of step t + 1 (0 at the last step).
    float gg[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) gg[i] = 0.f;
    auto add_gz = [&](int k, const F4& e4) {
      const F4 gz = bf4_at(gzb, ((c * K + k) * Ds + dd) * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = gz.v[i] + g_smp.v[i] / (float)K;
        gg[i] += g;
        gg[4 + i] += g * e4.v[i];
      }
    };
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int k = sub + j * ln.tpe;
      if (live && k < K) add_gz(k, pep[j]);
    }
    for (int k = sub + kPre * ln.tpe; live && k < K; k += ln.tpe)
      add_gz(k, ldg4(a.eps + (((size_t)t * K + k) * a.B + b) * D + d));
    lane_sum(gg, ln.tpe);

    // Obs-PoE pieces, recomputed, and their VJP.
    float d_num[4], d_den[4], d_prior_m[4], d_prior_s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gim = g_im.v[i] + gg[i], gis = g_is.v[i] + gg[4 + i];
      const float var_p = prior_s.v[i] * prior_s.v[i] + kEps;
      const float prec_p = 1.f / var_p;
      const float num = prior_m.v[i] * prec_p + num_o[i], den = prec_p + den_o[i];
      const bool low = den < kPrecFloor;
      const float safe = low ? 1.f : den;
      d_num[i] = low ? 0.f : gim / safe;
      d_den[i] = low ? 0.f : (-gim * num / (safe * safe) -
                              0.5f * gis * pow_m15_(safe));
      d_prior_m[i] = d_num[i] * prec_p + g_pm.v[i];
      d_prior_s[i] = (d_num[i] * prior_m.v[i] + d_den[i]) *
                         (-2.f * prior_s.v[i] / (var_p * var_p)) + g_ps.v[i];
    }
    // The observation experts' VJP, last: its loads are the obs ones again.
    auto obs_vjp = [&]() {
      for (int m = sub; live && m < M; m += ln.tpe) {
        const size_t tm = (size_t)t * M + m;
        const bool mk = __ldg(a.obs_mask + tm * a.B + b) > 0.f;
        const size_t o = (tm * a.B + b) * D + d;
        const F4 om = ldg4(a.obs_mean + o), os = ldg4(a.obs_std + o);
        float dm[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float var_o = os.v[i] * os.v[i] + kEps;
          const float prec = sign_(os.v[i]) / var_o;
          const float d_prec = mk ? d_num[i] * om.v[i] + d_den[i] : 0.f;
          dm[i] = mk ? d_num[i] * prec : 0.f;
          ds[i] = d_prec * (-2.f * sign_(os.v[i]) * os.v[i] / (var_o * var_o));
        }
        st4(a.d_obs_mean + o, dm);
        st4(a.d_obs_std + o, ds);
      }
    };
    if (t == 0) {  // the global prior was the prior at t = 0
      obs_vjp();
      if (live && sub == 0) {
        float* pgm = a.d_glb_mean + bd;
        float* pgs = a.d_glb_std + bd;
        float vm[4], vs[4];
        const F4 om = ld4(pgm), os = ld4(pgs);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vm[i] = om.v[i] + d_prior_m[i];
          vs[i] = os.v[i] + d_prior_s[i];
        }
        st4(pgm, vm);
        st4(pgs, vs);
      }
      continue;
    }

    // PoE2 + mixture, recomputed from the rows, then their VJP.
    float p1[4], m3[12];
#pragma unroll
    for (int i = 0; i < 4; ++i) p1[i] = 1.f / (gs.v[i] * gs.v[i] + kEps);
#pragma unroll
    for (int i = 0; i < 12; ++i) m3[i] = 0.f;
    auto rows_of = [&](int k, F4& a2, F4& zl, F4& zn, F4& sr) {
      const size_t r = (t_rows + k) * B + b;
      const float* y = a.ys + r * ly;
      a2 = ld4(y + la + d);
      zl = ld4(y + 2 * H + d);
      zn = ld4(y + la + D + d);
      sr = ld4(y + la + 2 * D + d);
    };
    auto mix = [&](const F4& a2, const F4& zl, const F4& zn, const F4& sr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ppm, pps;
        poe2f(gm.v[i], p1[i], a2.v[i], zl.v[i], zn.v[i], sr.v[i], a.min_std,
             ppm, pps);
        m3[i] += ppm;
        m3[4 + i] += pps * pps;
        m3[8 + i] += ppm * ppm;
      }
    };
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int k = sub + j * ln.tpe;
      if (live && k < K) mix(pa2[j], pzl[j], pzn[j], psr[j]);
    }
    for (int k = sub + kPre * ln.tpe; live && k < K; k += ln.tpe) {
      F4 a2, zl, zn, sr;
      rows_of(k, a2, zl, zn, sr);
      mix(a2, zl, zn, sr);
    }
    lane_sum(m3, ln.tpe);
    float mu[4], d_var[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mu[i] = m3[i] / (float)K;
      const float var = m3[4 + i] / (float)K + m3[8 + i] / (float)K - mu[i] * mu[i];
      const float ps_val = sqrtf(fmaxf(var, kEps));  // floored at _EPS, as on the TPU
      d_var[i] = (var > 0.f) ? d_prior_s[i] / (2.f * ps_val) : 0.f;
    }
    float dg[8], bs[12];  // bs: the lane's sums of d_zlin, d_a2, d_sraw
#pragma unroll
    for (int i = 0; i < 8; ++i) dg[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) bs[i] = 0.f;
    auto vjp = [&](int k, const F4& a2v, const F4& zlv, const F4& znv,
                   const F4& srv) {
      const int row = c * K + k;
      uint16_t* y = a.ys_bf + ((t_rows + k) * B + b) * ly;
      float d_sraw[4], d_a2[4], d_zlin[4], d_zn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float gate = sigm(a2v.v[i]);
        const float zl = zlv.v[i], zn = znv.v[i], sraw = srv.v[i];
        const float qm = (1.f - gate) * zl + gate * zn;
        const float qs = softp(sraw) + a.min_std;
        const float q2 = qs * qs + kEps;
        const float p2 = 1.f / q2;
        const float den2 = p1[i] + p2;
        const float num2 = gm.v[i] * p1[i] + qm * p2;
        const float ppm = num2 / den2;
        const float pps = rsqrtf(den2);
        const float d_ppm = d_prior_m[i] / (float)K +
                            d_var[i] * 2.f * (ppm - mu[i]) / (float)K;
        const float d_pps = d_var[i] * 2.f * pps / (float)K;
        const float d_num2 = d_ppm / den2;
        const float d_den2 = -d_ppm * num2 / (den2 * den2) - 0.5f * d_pps * pow_m15_(den2);
        const float d_qm = d_num2 * p2;
        const float d_p2 = d_num2 * qm + d_den2;
        const float d_qs = d_p2 * (-2.f * qs / (q2 * q2));
        dg[i] += d_num2 * p1[i];
        dg[4 + i] += d_num2 * gm.v[i] + d_den2;
        d_sraw[i] = d_qs * sigm(sraw);
        d_a2[i] = d_qm * (zn - zl) * gate * (1.f - gate);
        d_zlin[i] = d_qm * (1.f - gate);
        d_zn[i] = d_qm * gate;  // d_znonlin, partial
      }
      st_bf4(y + la + 2 * D + d, d_sraw);
      st_bf4(y + la + d, d_a2);
      st_bf4(y + 2 * H + d, d_zlin);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bs[i] += d_zlin[i];
        bs[4 + i] += d_a2[i];
        bs[8 + i] += d_sraw[i];
      }
      st4(zp + row * Ds + dd, d_zn);
      put_bf4(sm, dfbuf + swz(rb, row, d), d_a2);
      put_bf4(sm, dfbuf + swz(rb, row, D + d), d_sraw);
      put_bf4(sm, g7buf + swz(rb, row, 2 * H + d), d_zlin);
    };
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int k = sub + j * ln.tpe;
      if (live && k < K) vjp(k, pa2[j], pzl[j], pzn[j], psr[j]);
    }
    for (int k = sub + kPre * ln.tpe; live && k < K; k += ln.tpe) {
      F4 a2, zl, zn, sr;
      rows_of(k, a2, zl, zn, sr);
      vjp(k, a2, zl, zn, sr);
    }
    lane_sum(dg, ln.tpe);
    lane_sum(bs, ln.tpe);
    if (live && sub == 0) {
      float* acc = bacc + c * 3 * Ds + dd;
      add4(acc, bs);
      add4(acc + Ds, bs + 4);
      add4(acc + 2 * Ds, bs + 8);
    }
    obs_vjp();
    if (live && sub == 0) {
      float* pgm = a.d_glb_mean + bd;
      float* pgs = a.d_glb_std + bd;
      const F4 om = ld4(pgm), os = ld4(pgs);
      float vm[4], vs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float q = gs.v[i] * gs.v[i] + kEps;
        vm[i] = om.v[i] + dg[i];
        vs[i] = os.v[i] + dg[4 + i] * (-2.f * gs.v[i] / (q * q));
      }
      st4(pgm, vm);
      st4(pgs, vs);
    }
  }
}

__device__ void scan_bwd(const Args& a) {
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) unsigned long long wbar;
  Ctx cx;
  setup(cx, a, 0, raw);
  const Cluster cl(a);
  const int D = a.D, H = a.H, Ds = cl.Ds, Hs = cl.Hs;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D;
  const uint32_t bar = smem_u32(&wbar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cx.wimg = a.wimg_fwd + (size_t)cl.rank * a.img_bytes_fwd;
  if (a.resident) bulk_load(cx.sm_addr, cx.wimg, cx.L.wbytes, bar, 0);
  load_bias(a, cx, cl);
  {
    const int n = bacc_floats(a.rb, a.cols, Hs, Ds);
    float* acc = a.bacc + (size_t)blockIdx.x * n;
    for (int i = threadIdx.x; i < n; i += kThreads) acc[i] = 0.f;
  }
  cluster_sync();
  if (a.T > 1) recompute(a, cx, cl);
  // Every peer is done with the forward layout before the backward's is
  // written; then the transposed weights replace the forward's.
  fence_async_cta();
  cluster_sync();
  setup(cx, a, 1, raw);
  cx.wimg = a.wimg + (size_t)cl.rank * a.img_bytes;
  if (a.resident) bulk_load(cx.sm_addr, cx.wimg, cx.L.wbytes, bar, 1);
  const float* zp = reinterpret_cast<const float*>(cx.sm + cx.L.loc);
  char* gzb = cx.sm + cx.L.loc + a.rb * Ds * 4;  // the z cotangent, bf16
  for (int i = threadIdx.x; i < a.rb * Ds / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(gzb)[i] = 0u;
  __syncthreads();

  const Job p5[2] = {Job{0, D, D, 1, Ds, 0}, Job{0, 0, D, 2, Hs, 1}};
  const Job p6[1] = {Job{1, 0, D, 3, Hs, 2}};
  const Job p7[1] = {Job{2, 0, la, 0, Ds, 3}};
  const int rows = cl.rows;
  // The CTA's accumulators of the bias gradients' sums: [d_a1 | d_b1 (Hs
  // each) | d_znonlin (Ds)] for each tile row, then [d_zlin | d_a2 |
  // d_sraw] (Ds each) for each batch column (bwd_elementwise).
  const int nb = 2 * Hs + Ds;
  float* const bacc = a.bacc + (size_t)blockIdx.x *
                                   bacc_floats(a.rb, a.cols, Hs, Ds);
  char* stage = gzb + a.rb * Ds * 2;  // d_a1, rb x Hs bf16
  for (int t = a.T - 1; t >= 0; --t) {
    bwd_elementwise(a, cx, cl, t);
    if (t == 0) break;
    __syncthreads();
    // Every peer is done with the last step's z-cotangent product, which
    // read the columns of d_a1 and d_b1 that [d_a2 | d_sraw] may share
    // (its wgmma waited for): no data crosses, so no release.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    push_cols(cx, 0, rows, cl.d0, Ds, a.C, cl.rank);
    push_cols(cx, 0, rows, D + cl.d0, Ds, a.C, cl.rank);
    push_cols(cx, 2, rows, 2 * H + cl.d0, Ds, a.C, cl.rank);
    publish();
    // d_znonlin += d_sraw @ ws;  d_a1 = (d_a2 @ wg2) * (h1 > 0)
    run_phase(cx, p5, 2, [=, &a](int tag, int row, int n, float v0, float v1,
                                 const Ahead& pv) {
      if (row >= rows) return;
      const size_t r = cl.xrow(a, t, row);
      v0 = round_bf(v0);
      v1 = round_bf(v1);
      float* acc;
      if (tag == 0) {  // plus the partial d_znonlin of the elementwise VJP
        const int d = cl.d0 + n;
        v0 += zp[row * Ds + n];
        v1 += zp[row * Ds + n + 1];
        *reinterpret_cast<uint32_t*>(a.ys_bf + r * ly + la + D + d) =
            pack_bf2(v0, v1);
        acc = bacc + row * nb + 2 * Hs + n;
        put_bf2(cx.sm, cx.L.buf[1] + swz(a.rb, row, d), v0, v1);
      } else {  // staged: its columns may share [d_a2 | d_sraw]'s
        const int h = cl.h0 + n;  // pv.mask: h1, its ReLU mask
        v0 *= on0(pv.mask);
        v1 *= on1(pv.mask);
        *reinterpret_cast<uint32_t*>(a.ys_bf + r * ly + h) = pack_bf2(v0, v1);
        acc = bacc + row * nb + n;
        put_bf2(stage, (row * Hs + n) * 2, v0, v1);
      }
      *reinterpret_cast<float2*>(acc) =
          make_float2(pv.acc.x + v0, pv.acc.y + v1);
    }, [=, &a](int tag, int row, int n) {
      if (row >= rows) return Ahead{make_float2(0.f, 0.f), 0u};
      const float* acc = bacc + row * nb + (tag == 0 ? 2 * Hs : 0) + n;
      return Ahead{*reinterpret_cast<const float2*>(acc),
                   tag == 0 ? 0u : *reinterpret_cast<const uint32_t*>(
                       a.xs_bf + cl.xrow(a, t, row) * lx + cl.h0 + n)};
    });
    __syncthreads();
    push_cols(cx, 1, rows, cl.d0, Ds, a.C, cl.rank);
    publish();
    // Every peer is done with [d_a2 | d_sraw]: d_a1 goes to its columns.
    push_stage(cx, stage, 2, rows, cl.h0, Hs, a.C, cl.rank);
    // d_b1 = (d_znonlin @ wn2) * (hn > 0)
    run_phase(cx, p6, 1, [=, &a](int, int row, int n, float v0, float v1,
                                 const Ahead& pv) {
      if (row >= rows) return;
      const size_t r = cl.xrow(a, t, row);
      const int h = H + cl.h0 + n;  // pv.mask: hn, its ReLU mask
      v0 = round_bf(v0) * on0(pv.mask);
      v1 = round_bf(v1) * on1(pv.mask);
      *reinterpret_cast<uint32_t*>(a.ys_bf + r * ly + h) = pack_bf2(v0, v1);
      *reinterpret_cast<float2*>(bacc + row * nb + Hs + n) =
          make_float2(pv.acc.x + v0, pv.acc.y + v1);
      put_bf2(cx.sm, cx.L.buf[2] + swz(a.rb, row, h), v0, v1);
    }, [=, &a](int, int row, int n) {
      if (row >= rows) return Ahead{make_float2(0.f, 0.f), 0u};
      return Ahead{*reinterpret_cast<const float2*>(bacc + row * nb + Hs + n),
                   *reinterpret_cast<const uint32_t*>(
                       a.xs_bf + cl.xrow(a, t, row) * lx + H + cl.h0 + n)};
    });
    __syncthreads();
    push_cols(cx, 2, rows, H + cl.h0, Hs, a.C, cl.rank);
    publish();
    // The z cotangent: [d_a1 | d_b1 | d_zlin] @ [gate_1; nonlin_1; z_lin].
    run_phase(cx, p7, 1, [=, &a](int, int row, int n, float v0, float v1, float2 pv) {
      if (row >= rows) return;
      put_bf2(gzb, (row * Ds + n) * 2, v0, v1);
    });
    __syncthreads();
  }
  // The cluster's partial of the bias gradients: the CTA's columns, each
  // the sum of its accumulators over the tile rows (or batch columns) in
  // order.
  __syncthreads();
  const float* bcol = bacc + a.rb * nb;  // [d_zlin | d_a2 | d_sraw] a column
  for (int j = threadIdx.x; j < nb + 3 * Ds; j += kThreads) {
    float sum = 0.f;
    int col;
    if (j < nb) {
      for (int r = 0; r < rows; ++r) sum += bacc[r * nb + j];
      col = j < Hs ? cl.h0 + j
          : j < 2 * Hs ? H + cl.h0 + j - Hs
                       : la + D + cl.d0 + j - 2 * Hs;
    } else {
      const int q = (j - nb) / Ds, dd = (j - nb) % Ds;
      for (int c = 0; c < cl.g; ++c) sum += bcol[(c * 3 + q) * Ds + dd];
      col = (q == 0 ? 2 * H : q == 1 ? la : la + 2 * D) + cl.d0 + dd;
    }
    a.bias_part[(size_t)(blockIdx.x / a.C) * ly + col] = sum;
  }
  cluster_sync();  // no CTA leaves while a peer may still write to it
}

}  // namespace bf16scan

__global__ void __launch_bounds__(bf16scan::kThreads, 1)
    bfvi_scan_fwd_bf16_kernel(const __grid_constant__ bf16scan::Args a) {
  bf16scan::scan_fwd(a);
}

__global__ void __launch_bounds__(bf16scan::kThreads, 1)
    bfvi_scan_bwd_bf16_kernel(const __grid_constant__ bf16scan::Args a) {
  bf16scan::scan_bwd(a);
}

// One launch of `kern` as the plan says: clusters of C CTAs over the
// column groups. Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a
// plan that does not match the kernel's own layout.
cudaError_t launch_bf16_scan(void (*kern)(bf16scan::Args), int bwd,
                             const bf16scan::Args& a, cudaStream_t st) {
  using namespace bf16scan;
  if (a.C < 1 || a.C > kMaxCluster || a.D % (8 * a.C) || a.H % (8 * a.C) ||
      a.D % 16 || a.H % 16 || a.rb % 8 || a.rb > kTileRows ||
      a.cols * a.K > a.rb || a.smem != smem_bytes(bwd, a.D, a.H, a.C, a.rb,
                                                  a.resident))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.cols - 1) / a.cols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * a.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bf16scan::Args bf16_args(const float* obs_mean, const float* obs_std,
                         const float* obs_mask, const float* glb_mean,
                         const float* glb_std, const float* b1,
                         const float* bg2, const float* bn2, const float* bs,
                         const float* eps, int T, int M, int B, int K, int D,
                         int H, float min_std, const int* plan) {
  bf16scan::Args a = {};
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.b1 = b1; a.bg2 = bg2; a.bn2 = bn2; a.bs = bs;
  a.T = T; a.M = M; a.B = B; a.K = K; a.D = D; a.H = H; a.min_std = min_std;
  a.cols = plan[0]; a.C = plan[1]; a.rb = plan[2]; a.resident = plan[3];
  a.smem = plan[4];
  return a;
}

}  // namespace

extern "C" {

// The bf16 forward. The weights come as `wimg`: per CTA rank, the
// bfloat16 image of its slices (img_bytes each, ops/cuda/bfvi_scan.py:
// bf16_pack); w1, wg2, wn2 and ws are not read. plan = [columns a
// cluster, CTAs a cluster, rows a tile, resident, shared-memory bytes].
// work: null, or (T-1) K B rows [h1 | hn | z_nonlin] that the forward
// writes for its activations (a check against the backward's recompute);
// bar is not read.
int bfvi_scan_fwd(const float* obs_mean, const float* obs_std,
                  const float* obs_mask, const float* glb_mean,
                  const float* glb_std, const float* w1, const float* b1,
                  const float* wg2, const float* bg2, const float* wn2,
                  const float* bn2, const float* ws, const float* bs,
                  const float* eps, float* prior_mean, float* prior_std,
                  float* infer_mean, float* infer_std, float* samples,
                  float* z_traj, float* work, unsigned* bar, int T, int M,
                  int B, int K, int D, int H, float min_std, void* stream,
                  const void* wimg, int img_bytes, const int* plan) {
  (void)w1; (void)wg2; (void)wn2; (void)ws; (void)bar;
  bf16scan::Args a = bf16_args(obs_mean, obs_std, obs_mask, glb_mean, glb_std,
                               b1, bg2, bn2, bs, eps, T, M, B, K, D, H,
                               min_std, plan);
  a.wimg = reinterpret_cast<const char*>(wimg);
  a.img_bytes = img_bytes;
  a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.infer_mean = infer_mean; a.infer_std = infer_std;
  a.samples = samples; a.z_traj = z_traj; a.fwd_rows = work;
  return (int)launch_bf16_scan(bfvi_scan_fwd_bf16_kernel, 0, a,
                               (cudaStream_t)stream);
}

// The bf16 backward: wimg holds the backward's images (the transposed
// slices), wimg_fwd the forward's, for the recompute; gz and bar are not
// read, nor is xs: ys (f32, bfvi_scan.cuh's layout) keeps only the
// recompute's z_lin, a2, z_nonlin (in d_znonlin's columns) and s_raw, the
// cotangents go to ys_bf. xs_bf, ys_bf and zs_bf: the weight gradients'
// rows in bfloat16 (bfvi_scan.cuh's layouts; zs_bf as z_traj's first (T-1)
// K B rows); bacc: scratch of bacc_floats(...) f32 a CTA; bias_part: one
// partial of the 2H + 4D bias gradients' sums a cluster.
int bfvi_scan_bwd(const float* obs_mean, const float* obs_std,
                  const float* obs_mask, const float* glb_mean,
                  const float* glb_std, const float* w1, const float* b1,
                  const float* wg2, const float* bg2, const float* wn2,
                  const float* bn2, const float* ws, const float* bs,
                  const float* eps, const float* z_traj,
                  const float* prior_mean, const float* prior_std,
                  const float* g_pm, const float* g_ps, const float* g_im,
                  const float* g_is, const float* g_smp, float* d_obs_mean,
                  float* d_obs_std, float* d_glb_mean, float* d_glb_std,
                  float* xs, float* ys, float* gz, unsigned* bar, int T,
                  int M, int B, int K, int D, int H, float min_std,
                  void* stream, const void* wimg, int img_bytes,
                  const void* wimg_fwd, int img_bytes_fwd, const int* plan,
                  uint16_t* xs_bf, uint16_t* ys_bf, uint16_t* zs_bf,
                  float* bacc, float* bias_part) {
  (void)w1; (void)wg2; (void)wn2; (void)ws; (void)gz; (void)bar;
  bf16scan::Args a = bf16_args(obs_mean, obs_std, obs_mask, glb_mean, glb_std,
                               b1, bg2, bn2, bs, eps, T, M, B, K, D, H,
                               min_std, plan);
  a.wimg = reinterpret_cast<const char*>(wimg);
  a.img_bytes = img_bytes;
  a.wimg_fwd = reinterpret_cast<const char*>(wimg_fwd);
  a.img_bytes_fwd = img_bytes_fwd;
  a.z_in = z_traj; a.prior_mean_in = prior_mean; a.prior_std_in = prior_std;
  a.g_pm = g_pm; a.g_ps = g_ps; a.g_im = g_im; a.g_is = g_is; a.g_smp = g_smp;
  a.d_obs_mean = d_obs_mean; a.d_obs_std = d_obs_std;
  a.d_glb_mean = d_glb_mean; a.d_glb_std = d_glb_std;
  a.xs = xs; a.ys = ys;
  a.xs_bf = xs_bf; a.ys_bf = ys_bf; a.zs_bf = zs_bf;
  a.bacc = bacc; a.bias_part = bias_part;
  return (int)launch_bf16_scan(bfvi_scan_bwd_bf16_kernel, 1, a,
                               (cudaStream_t)stream);
}

// How many clusters of `C` CTAs with `smem` bytes of shared memory each
// the device runs at once.
int bfvi_scan_bf16_max_clusters(int bwd, int C, int smem) {
  void (*kern)(bf16scan::Args) =
      bwd ? bfvi_scan_bwd_bf16_kernel : bfvi_scan_fwd_bf16_kernel;
  if (cudaFuncSetAttribute((const void*)kern,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(bf16scan::kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
