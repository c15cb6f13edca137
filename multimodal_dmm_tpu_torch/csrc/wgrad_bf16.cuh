// The GTF weight gradients of MultiDMM(bf16_gtf=True) for Hopper (sm_90a):
// gtf_wgrad_bf16_kernel and its reduction gtf_wgrad_bf16_reduce_kernel,
// with the C entry point gtf_wgrad_bf16 of the bf16 library
// (bfvi_scan_bf16.cu).
//
// Replaces the weight-gradient products of the Pallas TPU kernel
// multimodal_dmm_tpu/ops/pallas/bfvi_scan.py: _bwd_kernel (:451-470), on
// the JAX package's bf16_gtf path: over all (T-1) K B rows r of the
// backward scan,
//   dW1 (2H+D x D) = sum_r y1[r]^T z[r]       y1 = [d_a1 | d_b1 | d_zlin]
//   dWg2 (D x H)   = sum_r d_a2[r]^T h1[r]
//   dWn2 (D x H)   = sum_r d_znonlin[r]^T hn[r]
//   dWs (D x D)    = sum_r d_sraw[r]^T z_nonlin[r]
// on the rows that the bf16 backward scans write in bfloat16 (bf16_scan.cuh
// and bfvi_scan.cuh's tiled route): zs, xs = [h1 | hn | z_nonlin] and ys =
// [y1 | d_a2 | d_znonlin | d_sraw], the images of the operands that JAX's
// products take. Each product of two bf16 values is exact, and the sums are
// f32 (JAX sums each step's product in bfloat16 instead: ROADMAP.md, Queue
// C). The bias gradients sum the f32 cotangents, as JAX's do: the scans hand
// them over as partials of those sums (bias_part), which the reduction adds
// in order.
//
// What bounds it on the H100: bytes. At Weizmann's K = 25 launch (60,000
// rows, D = H = 256) the rows are 2,560 bf16 values, 307 MB: 0.092 ms at
// 3.35 TB/s; the products are 47 GFLOP, 0.048 ms at 989 TFLOP/s.
//
// Design. Each output is cut into tiles of 64 rows (wgmma's M) by 128
// columns; a unit is two tiles of one product that share their columns,
// one a consumer warpgroup, and the grid is the units times the row ranges
// ("splits", wgrad_splits) that fill the SMs' waves, one CTA an SM, as
// evenly as the rows allow. A CTA walks its row
// range in stages of 64 rows: a producer warp keeps a ring of four stages
// in flight, each the 64 x 64 boxes of the unit's y columns and x columns
// brought by TMA (cp.async.bulk.tensor, 128-byte swizzle) and completed on
// an mbarrier; each consumer warpgroup runs wgmma m64n64k16 on them, both
// operands MN-major from shared memory (the rows are the reduction), four
// 16-deep steps a stage into a fresh accumulator, which it then adds to its
// running f32 sum with ordinary rounded adds (the tensor cores' own f32
// adds truncate, which over thousands of rows would bias a sum). Ragged
// edges need no code: TMA fills rows past the last and columns past the
// tensor with zeros, and the store skips output rows and columns past the
// product's. Each CTA writes its split's partial of its tiles; the
// reduction sums the splits, and the bias partials, in a fixed order. No
// atomics: two runs agree bit for bit.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wgradbf16 {

constexpr int kRows = 64;                     // rows a stage: four k16 steps
constexpr int kBoxBytes = kRows * 64 * 2;     // a 64 x 64 bf16 box: 8 KB
constexpr int kStages = 4;
constexpr int kStageBytes = 4 * kBoxBytes;    // two y boxes, two x boxes
constexpr int kSmem = kStages * kStageBytes + 1024;
constexpr int kThreads = 2 * 128 + 32;        // two consumer warpgroups, a producer warp
constexpr int kUnitRows = 128, kUnitCols = 128;

// dW (M x N, PyTorch's (out, in) layout, at `out` in a partial) = sum over
// rows of Y[:, y_col : y_col + M]^T X[:, x_col : x_col + N], X the zs rows
// (x_map 0) or the xs rows (1).
struct Job {
  int y_col, x_map, x_col, M, N;
  long long out;
};

struct Params {
  CUtensorMap ys, xs, zs;
  Job jobs[4];
  int units, splits, stages;
  long long n_w;   // floats of a partial: the four weight gradients
  float* partial;  // (splits, n_w)
};

__host__ __device__ inline int job_units(const Job& j) {
  return ((j.M + kUnitRows - 1) / kUnitRows) * ((j.N + kUnitCols - 1) / kUnitCols);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for phase `parity` of the mbarrier at `bar`; a wait still open after
// 10 s traps, so a fault ends the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const unsigned long long t0 = now_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (now_ns() - t0 > 10000000000ull) __trap();
  }
}

// One 64 x 64 box of a row tensor (columns col.., rows row..) into shared
// memory at dst, completed on the mbarrier at bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(bar) : "memory");
}

// A wgmma shared-memory descriptor of a box in the 128-byte swizzle read
// MN-major: 64 values of M (or N) in each 128-byte row, the rows the
// reduction, 8-row groups 1,024 bytes apart. (With one 64-wide block along
// M or N, the block stride is unused; both offsets are 1,024.)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
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
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B on one m64n64k16 step, bf16 in, f32 out, A and B MN-major
// from shared memory (both transposed); `acc` 0 starts the sum (d = A B).
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                    int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// A consumer warpgroup's tile: 64 output rows by NB boxes of 64 columns,
// summed over the CTA's stages, then stored to its split's partial.
template <int NB>
__device__ __forceinline__ void consume(const Params& p, const Job& jb, int m0,
                                        int n0, int n_st, uint32_t sm_addr,
                                        uint32_t full, uint32_t empty,
                                        int wg) {
  float tot[NB][32], acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[b][i] = acc[b][i] = 0.f;
  for (int i = 0; i < n_st; ++i) {
    const int slot = i % kStages;
    mbar_wait(full + 8 * slot, (i / kStages) & 1);
    const uint32_t st = sm_addr + slot * kStageBytes;
    const uint32_t a = st + wg * kBoxBytes, x = st + 2 * kBoxBytes;
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        mma(acc[b], desc(a + k * 2048), desc(x + b * kBoxBytes + k * 2048),
            k > 0);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    // This thread's reads of the slot are done: the producer may refill it.
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(empty + 8 * slot) : "memory");
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < 32; ++r) tot[b][r] += acc[b][r];
  }
  // The accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1).
  const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
  float* out = p.partial + (size_t)(blockIdx.x / p.units) * p.n_w + jb.out;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * w + (lane >> 2) + 8 * h;
        const int n = n0 + 64 * b + 8 * j + 2 * (lane & 3);
        if (m < jb.M && n < jb.N)
          *reinterpret_cast<float2*>(out + (size_t)m * jb.N + n) =
              make_float2(tot[b][4 * j + 2 * h], tot[b][4 * j + 2 * h + 1]);
      }
}

}  // namespace wgradbf16

// One CTA: unit blockIdx.x % units (a product's two 64-row tiles over 128
// columns) over the row stages of split blockIdx.x / units.
__global__ void __launch_bounds__(wgradbf16::kThreads, 1)
    gtf_wgrad_bf16_kernel(const __grid_constant__ wgradbf16::Params p) {
  using namespace wgradbf16;
  extern __shared__ __align__(16) char raw[];
  __shared__ __align__(8) unsigned long long bars[2 * kStages];
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t sm_addr = (raw_addr + 1023u) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * kStages;

  int u = blockIdx.x % p.units, j = 0;
  while (u >= job_units(p.jobs[j])) u -= job_units(p.jobs[j++]);
  const wgradbf16::Job jb = p.jobs[j];  // (bfvi_scan.cuh has a Job too)
  const int pairs = (jb.M + kUnitRows - 1) / kUnitRows;
  const int m0 = (u % pairs) * kUnitRows, n0 = (u / pairs) * kUnitCols;
  const int n_act = m0 + 64 < jb.M ? 2 : 1;  // warpgroups with a tile
  const int nbx = n0 + 64 < jb.N ? 2 : 1;    // x boxes a stage
  const int split = blockIdx.x / p.units;
  const int s0 = (int)((long long)split * p.stages / p.splits);
  const int n_st = (int)((long long)(split + 1) * p.stages / p.splits) - s0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(full + 8 * i), "r"(1) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(empty + 8 * i), "r"(128 * n_act) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp == 8) {  // the producer
    if ((threadIdx.x & 31) == 0) {
      const CUtensorMap* xmap = jb.x_map ? &p.xs : &p.zs;
      const int bytes = (n_act + nbx) * kBoxBytes;
      for (int i = 0; i < n_st; ++i) {
        const int slot = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * slot, (i / kStages - 1) & 1);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(full + 8 * slot), "r"(bytes) : "memory");
        const int row = (s0 + i) * kRows;
        const uint32_t st = sm_addr + slot * kStageBytes;
        for (int w = 0; w < n_act; ++w)
          tma_box(st + w * kBoxBytes, &p.ys, jb.y_col + m0 + 64 * w, row,
                  full + 8 * slot);
        for (int b = 0; b < nbx; ++b)
          tma_box(st + (2 + b) * kBoxBytes, xmap, jb.x_col + n0 + 64 * b, row,
                  full + 8 * slot);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  if (wg >= n_act) return;
  if (nbx == 2)
    consume<2>(p, jb, m0 + 64 * wg, n0, n_st, sm_addr, full, empty, wg);
  else
    consume<1>(p, jb, m0 + 64 * wg, n0, n_st, sm_addr, full, empty, wg);
}

// out[i] = the sum over the splits of partial[s][i], in order, for the n_w
// weight-gradient floats; then the n_b bias gradients, each the sum over the
// n_bp bias partials in order.
__global__ void gtf_wgrad_bf16_reduce_kernel(const float* partial, int splits,
                                             long long n_w,
                                             const float* bias_part, int n_bp,
                                             int n_b, float* out) {
  const long long n = n_w + n_b;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (i < n_w) {
      for (int s = 0; s < splits; ++s) sum += __ldg(partial + s * n_w + i);
    } else {
      for (int s = 0; s < n_bp; ++s)
        sum += __ldg(bias_part + (long long)s * n_b + (i - n_w));
    }
    out[i] = sum;
  }
}

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

// The tensor map of `rows` rows of `width` bf16 values: boxes of 64 x 64,
// the 128-byte swizzle; 0 on success.
int row_map(CUtensorMap* map, const void* base, int rows, int width) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {64, wgradbf16::kRows}, one[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dim, stride, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The four products of the rows (jobs[]) at widths (D, H), their outputs
// laid out as gtf_wgrad_bf16's result.
void wgrad_jobs(wgradbf16::Job* jobs, int D, int H) {
  const int la = 2 * H + D;
  const long long o1 = (long long)la * D, o2 = o1 + (long long)D * H;
  const long long o3 = o2 + (long long)D * H;
  jobs[0] = wgradbf16::Job{0, 0, 0, la, D, 0};
  jobs[1] = wgradbf16::Job{la, 1, 0, D, H, o1};
  jobs[2] = wgradbf16::Job{la + D, 1, H, D, H, o2};
  jobs[3] = wgradbf16::Job{la + 2 * D, 1, 2 * H, D, D, o3};
}

// Units of the weight-gradient kernel at widths (D, H).
int wgrad_units(int D, int H) {
  wgradbf16::Job jobs[4];
  wgrad_jobs(jobs, D, H);
  int units = 0;
  for (const wgradbf16::Job& j : jobs) units += wgradbf16::job_units(j);
  return units;
}

// Row ranges ("splits") of R rows at widths (D, H): the grid (units x
// splits, one CTA an SM) fills the card's waves as evenly as the rows
// allow, each range at least one stage. Up to one wave, as many splits as
// fit in it; past one wave, of 1-4 splits the count whose waves leave the
// fewest SMs idle (fewest splits on a tie).
int wgrad_splits(int R, int D, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int units = wgrad_units(D, H);
  const int stages = (R + wgradbf16::kRows - 1) / wgradbf16::kRows;
  const int most = units <= sms ? sms / units : 4;
  int best = 1;
  double cost = 1e30;
  for (int s = 1; s <= most && s <= stages; ++s) {
    const double c = (double)((units * s + sms - 1) / sms) / s;
    if (c < cost) best = s, cost = c;
  }
  return best;
}

}  // namespace

extern "C" {

// Floats of the scratch that gtf_wgrad_bf16 takes for R rows at widths
// (D, H): its splits' partials of the weight gradients.
long long gtf_wgrad_bf16_partial_floats(int R, int D, int H) {
  if (R <= 0) return 0;
  const long long la = 2LL * H + D;
  return wgrad_splits(R, D, H) * (la * D + 2LL * D * H + (long long)D * D);
}

// The GTF weight gradients from R rows in bfloat16 (zs: R x D, xs: R x
// (2H + D), ys: R x (2H + 4D)) at widths (D, H), multiples of 16, and n_bp
// partials of the 2H + 4D bias gradients' sums. out: [dW1 (2H+D x D) | dWg2
// (D x H) | dWn2 (D x H) | dWs (D x D) | db1 (2H+D) | dbg2 | dbn2 | dbs (D
// each)], weights in PyTorch's (out, in) layout; partial: scratch of
// gtf_wgrad_bf16_partial_floats(R, D, H) floats.
int gtf_wgrad_bf16(const void* zs, const void* xs, const void* ys,
                   const float* bias_part, int n_bp, float* partial,
                   float* out, int R, int D, int H, void* stream) {
  using namespace wgradbf16;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 || H % 16) return (int)cudaErrorInvalidValue;
  const int la = 2 * H + D, ly = la + 3 * D;
  Params p;
  wgrad_jobs(p.jobs, D, H);
  p.n_w = (long long)la * D + 2LL * D * H + (long long)D * D;
  p.partial = partial;
  p.stages = (R + kRows - 1) / kRows;
  p.splits = R > 0 ? wgrad_splits(R, D, H) : 0;
  p.units = wgrad_units(D, H);
  if (R > 0) {
    int err = row_map(&p.ys, ys, R, ly);
    if (!err) err = row_map(&p.xs, xs, R, la);
    if (!err) err = row_map(&p.zs, zs, R, D);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)gtf_wgrad_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    gtf_wgrad_bf16_kernel<<<p.units * p.splits, kThreads, kSmem, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  gtf_wgrad_bf16_reduce_kernel<<<264, 256, 0, st>>>(
      partial, p.splits, p.n_w, bias_part, n_bp, ly, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
