// BFVI filtering scan, forward and backward, for Hopper (sm_90a).
// bfvi_scan.cu builds the float32 kernels from this file. bfvi_scan_bf16.cu
// builds from it (BFVI_SCAN_BF16, at the end) the tiled bfloat16 scans,
// bfvi_scan_fwd_bf16_tiled_kernel and bfvi_scan_bwd_bf16_tiled_kernel,
// the route "tiled", which the launch plan (ops/cuda/bfvi_scan.py:
// bf16_scan_plan) gives no shape: they run where a caller names them, as
// the twin of the bf16 wgmma route (f32_scan.cuh), which takes every
// width and particle count that no cluster holds; the bfloat16 scans'
// cluster route from bf16_scan.cuh, which uses the elementwise helpers
// below; and the bfloat16 weight gradients from wgrad_bf16.cuh.
//
// Replaces the Pallas TPU kernels of multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:
//   bfvi_scan_fwd_kernel  <- bfvi_scan_pallas / _fwd_kernel
//   bfvi_scan_bwd_kernel  <- bfvi_scan_pallas_bwd / _bwd_kernel (hand-derived VJP)
//   gtf_wgrad_kernel      <- the weight-gradient products of _bwd_kernel
// and computes what they compute, in float32. The tiled bf16 scans are the
// same code on the engine's bf16 route (tf32x3.cuh), with the rounding
// points of the JAX package's MultiDMM(bf16_gtf=True) (its lax.scan path,
// gtf_apply_packed and its VJP):
//   - each product's operands are rounded to bfloat16 (the engine does
//     this as it builds fragments), and each product's f32 sum is rounded
//     to bfloat16 before the bias, the ReLU or an add (the epilogue);
//   - the backward's cotangents enter their products rounded as operands,
//     and the cotangent of z_{t-1}, whose three partial products are added
//     in the next elementwise phase, is rounded once after that add (JAX's
//     one product over the packed [gate_1; nonlin_1; z_lin]);
//   - the backward writes its rows for the weight gradients in bfloat16
//     (exact images of the products' operands) and the bias gradients' f32
//     sums of its cotangents (emit_bf16_rows).
// The backward recomputes the transition on every tile shape from the
// forward's: the bf16 route sums every product in one K-order on every
// shape (tf32x3.cuh), so the recomputed activations are the forward's bit
// for bit, also where a sum lies at a bfloat16 rounding midpoint.
//
// Layout (one scan direction; the caller flips time for backward passes):
//   obs_mean/obs_std (T, M, B, D), obs_mask (T, M, B), glb_mean/glb_std (B, D),
//   eps and z_traj (T, K, B, D), the other outputs (T, B, D). Row k * B + b
//   of step t is particle k of batch column b. GTF weights in PyTorch's
//   (out, in) layout: w1 (2H+D, D) = [gate_1; nonlin_1; z_lin] with b1,
//   wg2 (D, H), wn2 (D, H), ws (D, D) with their biases. The forward
//   products read them as (in, out) and the input-gradient products as
//   they are, so no transposed copy exists.
//
// Design. Every GTF product runs on the tensor cores in 3xTF32 through the
// tile engine of tf32x3.cuh (mma.sync m16n8k8, about f32's accuracy),
// weights and activations staged in shared memory by cp.async. A step's
// product is one tiled product over all K x B particle rows of the step,
// not one per batch column: a tile of BM rows reads each weight once from
// L2 for all of its rows (BM = 128 from 1,024 rows on, 64 where that
// leaves fewer than 128 tiles, 16 below 1,024 rows, where latency and not
// work sets the time). The scan kernels are cooperative launches of up to
// two CTAs per SM that walk the time loop together, phase by phase, with
// a grid barrier (about 1 us) between phases; activations live in device
// memory (L2-resident within a step) instead of one CTA's shared memory,
// so neither K nor the widths are bound by shared memory. Elementwise
// phases give each (b, d) one thread, or two at K > 1 that split the
// particles and meet in shared memory.
//
//   forward, step t >= 1:  A = [relu(gate_1) | relu(nonlin_1) | z_lin](z)
//                          G, N = gate_2(A), nonlin_2(A)   S = z_to_std(N)
//                          mixture, observation PoE, z_t = mu + eps sigma
//   backward: the transition is recomputed for all T - 1 steps at once
//   (three products over (T - 1) K B rows, straight into the rows the weight
//   gradients read), then per step, in reverse: the elementwise VJP; d_znon
//   and d_a1; d_b1; the particles' cotangent through w1, as three partial
//   products (one per 256-deep block of w1) that the next step's
//   elementwise phase adds in order.
//
// The TPU kernel carries the weight gradients in VMEM across its grid. Here
// the backward writes, for every particle row of every step, the activations
// xs = [h1 | hn | z_nonlin] and cotangents ys = [d_a1 | d_b1 | d_zlin | d_a2
// | d_znonlin | d_sraw] (the input side of dW1 is z_traj itself), and
// gtf_wgrad_kernel forms dW = X^T Y and db = 1^T Y over the (T-1) K B rows
// on the same engine, split over row ranges whose partials the caller sums
// in a fixed order. No float atomics anywhere: two runs agree bit for bit.
//
// L2 weight reads per step, training shapes (T = 25, B = 100, D = H = 256;
// the weights are 1.57 MB): before, every CTA (one per batch column) read
// all of them every step, 157 MB forward and 315 MB backward (two layouts).
// Now each weight is read once per row tile: forward K = 1 (100 rows, 7
// tiles of 16) 11 MB, 14x fewer; K = 25 (2,500 rows; 20 tiles of 128, 40
// of 64 for z_to_std) 37 MB, 4.3x fewer; the evaluation's smoothing pass
// (B = 25, 2 tiles) 3.1 MB against 39 MB, 12x fewer. Backward K = 25: 31 MB
// for the batched recompute plus 37 MB for the per-step products, 67 MB,
// 4.7x fewer; K = 1: 12.5 MB, 25x fewer.
//
// What bounds each launch on the H100: at K = 25 the products, 47 GFLOP
// forward, 94 GFLOP in the backward kernel and 47 in the weight gradients,
// three TF32 passes each: operations (0.29 ms forward at 495 TFLOP/s dense;
// bytes are a tenth of that). mma.sync itself reaches about 200 TFLOP/s of
// TF32 here, so three passes run at most at float32's rate; the engine
// gets about half of that (a standalone microbenchmark of the engine,
// PERF.md), and wgmma is the way past it. At K = 1 the work is 25 times
// smaller and the bound is latency: 24 steps of 4 dependent phases, each a
// grid barrier apart, with one wave of small tiles.
//
// D and H must be multiples of 4 here. Other widths (the spirals model's
// D = 5, H = 20) run zero-padded by the wrapper (ops/cuda/bfvi_scan.py) to
// the next multiple of 4, so the kernels do the padded work: at D = 5,
// H = 20 they run D = 8, whose products cost 1,536 FLOPs a particle row a
// step against the real 900 (1.7x) and whose elementwise phases take 8
// threads' work per column against 5 (1.6x). At those widths the bound is
// latency, as at K = 1 above: T - 1 steps of dependent phases, a grid
// barrier apart, each with a few tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::Acc;
using tf32x3::max_;
using tf32x3::NT;
using tf32x3::Operand;

// The product route of a kernel variant: its tile shapes (the scan's
// three, by rows, and the weight gradients'), and whether each product's
// output is rounded to bfloat16.
struct Tf32Route {
  using Large = tf32x3::Large;
  using Medium = tf32x3::Medium;
  using Small = tf32x3::Small;
  using WTile = tf32x3::LargePromoted;
  static constexpr bool BF16 = false;
};
struct Bf16Route {  // the tiled bf16 scans
  using Large = tf32x3::Bf16Large;
  using Medium = tf32x3::Bf16Medium;
  using Small = tf32x3::Bf16Small;
  static constexpr bool BF16 = true;
};

constexpr float kEps = 1e-8f;    // variance floor (_EPS)
constexpr float kPrecFloor = 1e-6f;

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float softplus_(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float rsqrt_(float x) { return 1.f / sqrtf(x); }
__device__ __forceinline__ float sign_(float x) {
  return (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
}
__device__ __forceinline__ float pow_m15_(float x) { return 1.f / (x * sqrtf(x)); }

// ---------------------------------------------------------------------------
// Products: jobs of one phase, their epilogues, the grid barrier
// ---------------------------------------------------------------------------

enum { EP_STORE = 0, EP_ADD = 1, EP_MASK = 2 };

// Where a product's tile goes: v (+ bias[n]) (ReLU for n < relu_cols) is
// stored to dst (columns below split) or dst2 (the others, from column 0);
// EP_ADD adds it to what is there, EP_MASK multiplies it by (mask > 0).
// On the bf16 route v is first rounded to bfloat16, unless keep_f32 (a
// partial product that is rounded after it is added to the others).
struct Epi {
  int mode;
  const float* bias;
  int relu_cols;
  float* dst;
  int ld;
  float* dst2;
  int ld2;
  int split;
  const float* mask;
  int ldm;
  int keep_f32;
};

struct Job {
  Operand a, b;
  int M, N, K;
  Epi ep;
};

__device__ __forceinline__ Epi store_to(float* dst, int ld, const float* bias,
                                        int n) {
  return Epi{EP_STORE, bias, 0, dst, ld, nullptr, 0, n, nullptr, 0};
}

template <bool BF16>
__device__ __forceinline__ void epi_pair(const Epi& e, int m, int n, float v0,
                                         float v1) {
  if (BF16 && !e.keep_f32) tf32x3::round_bf16x2(v0, v1);
  if (e.bias != nullptr) {
    v0 += __ldg(e.bias + n);
    v1 += __ldg(e.bias + n + 1);
  }
  if (n < e.relu_cols) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  float* p = n < e.split ? e.dst + (size_t)m * e.ld + n
                         : e.dst2 + (size_t)m * e.ld2 + (n - e.split);
  if (e.mode == EP_ADD) {
    const float2 o = __ldcg(reinterpret_cast<const float2*>(p));
    v0 += o.x;
    v1 += o.y;
  } else if (e.mode == EP_MASK) {
    const float2 mk = __ldcg(
        reinterpret_cast<const float2*>(e.mask + (size_t)m * e.ldm + n));
    v0 *= (mk.x > 0.f) ? 1.f : 0.f;
    v1 *= (mk.y > 0.f) ? 1.f : 0.f;
  }
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// This CTA's share of the tiles of jobs[0..nj), in grid-stride order.
template <class C, int LB>
__device__ void run_jobs_cfg(const Job* jobs, int nj, float* smem) {
  int total = 0;
  for (int j = 0; j < nj; ++j) total += tf32x3::tiles_of<C>(jobs[j].M, jobs[j].N);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int j = 0, local = tile;
    while (local >= tf32x3::tiles_of<C>(jobs[j].M, jobs[j].N)) {
      local -= tf32x3::tiles_of<C>(jobs[j].M, jobs[j].N);
      ++j;
    }
    const Job& jb = jobs[j];
    const int mt = (jb.M + C::BM - 1) / C::BM;
    const int m0 = (local % mt) * C::BM, n0 = (local / mt) * C::BN;
    Acc<C> acc;
    tf32x3::tile_product<C, tf32x3::A_MK, LB>(jb.a, jb.b, jb.M, jb.N, jb.K,
                                              m0, n0, smem, acc);
    const Epi ep = jb.ep;
    tf32x3::tile_store<C>(acc, jb.M, jb.N, m0, n0,
                          [&](int m, int n, float v0, float v1) {
                            epi_pair<C::BF16>(ep, m, n, v0, v1);
                          });
  }
}

// The tile shape of a phase whose jobs have M rows and, in all, this many
// large tiles (tf32x3.cuh).
enum { SMALL = 0, MEDIUM = 1, LARGE = 2 };
__host__ __device__ inline int tile_shape(int M, int large_tiles) {
  if (M < tf32x3::kLargeRows) return SMALL;
  return large_tiles < tf32x3::kFillTiles ? MEDIUM : LARGE;
}

// Tiles of a phase of jobs with M rows and the given output widths, on
// route R.
template <class R>
__host__ __device__ inline int phase_tiles(int M, const int* N, int nj) {
  int large = 0, medium = 0, small = 0;
  for (int j = 0; j < nj; ++j) {
    large += tf32x3::tiles_of<typename R::Large>(M, N[j]);
    medium += tf32x3::tiles_of<typename R::Medium>(M, N[j]);
    small += tf32x3::tiles_of<typename R::Small>(M, N[j]);
  }
  const int shape = tile_shape(M, large);
  return shape == LARGE ? large : (shape == MEDIUM ? medium : small);
}

// All jobs of a phase have the same rows M; the tile shape of route R
// follows M and how many large tiles the phase has.
template <class R, int LB>
__device__ __forceinline__ void run_jobs(const Job* jobs, int nj, float* smem) {
  int large = 0;
  for (int j = 0; j < nj; ++j)
    large += tf32x3::tiles_of<typename R::Large>(jobs[j].M, jobs[j].N);
  const int shape = tile_shape(jobs[0].M, large);
  if (shape == LARGE)
    run_jobs_cfg<typename R::Large, LB>(jobs, nj, smem);
  else if (shape == MEDIUM)
    run_jobs_cfg<typename R::Medium, LB>(jobs, nj, smem);
  else
    run_jobs_cfg<typename R::Small, LB>(jobs, nj, smem);
}

__device__ __forceinline__ unsigned long long globaltimer_() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Barrier over the whole (cooperatively launched, so co-resident) grid.
// *bar counts arrivals and is never reset within a launch: the n-th
// barrier waits for n * gridDim.x. Writes before it are visible to every
// CTA after it (fences around a release/acquire counter). The waiting
// CTAs poll it every 100 ns or so rather than in a tight loop. A barrier
// still waiting after 10 s traps, so a fault ends the launch with an
// error instead of hanging the device.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned long long t0 = globaltimer_();
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if ((int)(v - target) >= 0) break;
      if (globaltimer_() - t0 > 10000000000ull) __trap();
      __nanosleep(100);
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Elementwise parts
// ---------------------------------------------------------------------------

// Adds the masked, signed-precision observation experts of (t, b, d) to
// the PoE sums. The loads do not wait on the mask, so that all of them
// can be in flight together.
__device__ __forceinline__ void add_obs_experts(
    const float* __restrict__ mean, const float* __restrict__ std_,
    const float* __restrict__ mask, int t, int M, int B, int b, int D, int d,
    float& num, float& den) {
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    const size_t tm = (size_t)t * M + m;
    const size_t o = (tm * B + b) * D + d;
    const float mk = __ldg(mask + tm * B + b);
    const float os = __ldg(std_ + o), om = __ldg(mean + o);
    if (mk > 0.f) {
      const float prec = sign_(os) / (os * os + kEps);
      num += om * prec;
      den += prec;
    }
  }
}

struct Weights {  // PyTorch layout (out, in)
  const float *w1, *b1, *wg2, *bg2, *wn2, *bn2, *ws, *bs;
};

struct Dims {
  int T, M, B, K, D, H;
  float min_std;
};

// PoE(global prior, GTF(z_k)) of one particle: its mean and std.
__device__ __forceinline__ void poe2(float gm, float p1, float a2, float zl,
                                     float zn, float sraw, float min_std,
                                     float& ppm, float& pps) {
  const float gate = sigmoid_(a2);
  const float qm = (1.f - gate) * zl + gate * zn;
  const float qs = softplus_(sraw) + min_std;
  const float p2 = 1.f / (qs * qs + kEps);
  const float den2 = p1 + p2;
  ppm = (gm * p1 + qm * p2) / den2;
  pps = rsqrt_(den2);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float *obs_mean, *obs_std, *obs_mask, *glb_mean, *glb_std, *eps;
  Weights w;
  float *prior_mean, *prior_std, *infer_mean, *infer_std, *samples, *z_traj;
  // K B rows of [A (2H + D) | G (D) | N (D) | S (D)]: one step's activations.
  float* work;
  // Null, or (T-1) K B rows [h1 | hn | z_nonlin] that the forward writes
  // for its activations (a check against the backward's recompute).
  float* rows;
  unsigned* bar;
  Dims s;
};

// The elementwise phases give each (b, d) one thread at K = 1 and two at
// K > 1, which split the particles; their partial sums meet in shared
// memory and are added in group order, so every group holds the same sum.
// (Two, not more: at B = 100 the 25,600 elements then take one pass of
// the 264 resident CTAs, and a pass has a fixed cost of several
// microseconds.) A thread walks its particles, any number of them, in
// chunks of kChunk kept in registers, each chunk's loads all issued
// before any is used.
constexpr int kChunk = 8;
struct Lanes {
  int kg, KG, el, EPB;  // group, groups, element in the CTA's pass, elements
  __device__ explicit Lanes(int K)
      : KG(K > 1 ? 2 : 1), EPB(NT / KG) {
    kg = threadIdx.x / EPB;
    el = threadIdx.x % EPB;
  }
  // The particle of chunk c, slot i, of this thread (chunks of CH: the
  // same particles in the same order for every CH).
  template <int CH = kChunk>
  __device__ int particle(int c, int i) const { return kg + (c * CH + i) * KG; }
  // The chunks that hold particles for K of them.
  template <int CH = kChunk>
  __device__ int chunks(int K) const { return (K + KG * CH - 1) / (KG * CH); }
};

// The barrier of the NT threads that run the elementwise phases: all of
// a tiled kernel's, the consumer warps of f32_scan.cuh's wgmma kernels
// (whose producer warp takes no part in these phases).
__device__ __forceinline__ void lanes_sync() {
  asm volatile("bar.sync 8, %0;\n" ::"n"(NT) : "memory");
}

template <int NV>
__device__ __forceinline__ void group_sum(float (&v)[NV], float* red,
                                          const Lanes& ln) {
  if (ln.KG == 1) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) red[(i * ln.KG + ln.kg) * ln.EPB + ln.el] = v[i];
  lanes_sync();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float sum = 0.f;
    for (int g = 0; g < ln.KG; ++g) sum += red[(i * ln.KG + g) * ln.EPB + ln.el];
    v[i] = sum;
  }
  lanes_sync();
}

// CH: the particles whose loads a thread has in flight at once (fewer
// registers at fewer; the sums are the same bit for bit).
template <int CH = kChunk>
__device__ void fwd_elementwise(const FwdArgs& a, int t, float* red) {
  const Dims& s = a.s;
  const int D = s.D, H = s.H, K = s.K, M = s.M, B = s.B;
  const int lw = 2 * H + 4 * D, la = 2 * H + D;
  const float* A = a.work;
  const Lanes ln(K);
  for (int base = blockIdx.x * ln.EPB; base < B * D; base += gridDim.x * ln.EPB) {
    const int e = base + ln.el;
    const bool live = e < B * D;
    const int b = live ? e / D : 0, d = live ? e - b * D : 0;
    const size_t bd = (size_t)b * D + d;
    const float gm = __ldg(a.glb_mean + bd), gs = __ldg(a.glb_std + bd);
    // The observation experts' sums first, so that their loads are in
    // flight with the particles'.
    float num_o = 0.f, den_o = 0.f;
    add_obs_experts(a.obs_mean, a.obs_std, a.obs_mask, t, M, B, b, D, d,
                    num_o, den_o);
    float pm = gm, ps = gs;
    if (t > 0) {
      // PoE(global prior, GTF(z_k)) per particle, then the moment-matched
      // mixture over the K particles.
      const float p1 = 1.f / (gs * gs + kEps);
      float m3[3] = {0.f, 0.f, 0.f};
      for (int c = 0; c < ln.template chunks<CH>(K); ++c) {
        float a2[CH], zl[CH], zn[CH], sr[CH];
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int r = ln.template particle<CH>(c, i);
          if (live && r < K) {
            const float* row = A + ((size_t)r * B + b) * lw;
            a2[i] = __ldcg(row + la + d);
            zl[i] = __ldcg(row + 2 * H + d);
            zn[i] = __ldcg(row + la + D + d);
            sr[i] = __ldcg(row + la + 2 * D + d);
          }
        }
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          if (live && ln.template particle<CH>(c, i) < K) {
            float ppm, pps;
            poe2(gm, p1, a2[i], zl[i], zn[i], sr[i], s.min_std, ppm, pps);
            m3[0] += ppm;
            m3[1] += pps * pps;
            m3[2] += ppm * ppm;
          }
        }
      }
      group_sum(m3, red, ln);
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
    if (live && ln.kg == 0) {
      a.prior_mean[tbd] = pm;
      a.prior_std[tbd] = ps;
      a.infer_mean[tbd] = im;
      a.infer_std[tbd] = is;
    }
    float zs[1] = {0.f};
    for (int c = 0; c < ln.template chunks<CH>(K); ++c) {
      float ep[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = ln.template particle<CH>(c, i);
        if (live && r < K)
          ep[i] = __ldg(a.eps + (((size_t)t * K + r) * B + b) * D + d);
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = ln.template particle<CH>(c, i);
        if (live && r < K) {
          const float z = im + ep[i] * is;
          a.z_traj[(((size_t)t * K + r) * B + b) * D + d] = z;
          zs[0] += z;
        }
      }
    }
    group_sum(zs, red, ln);
    if (live && ln.kg == 0) a.samples[tbd] = zs[0] / (float)K;
  }
}

// The forward's rows [h1 | hn | z_nonlin] of step t >= 1, from the work
// rows (run in the phase of the last product, which reads neither A nor N).
__device__ void copy_fwd_rows(const FwdArgs& a, int t) {
  const Dims& s = a.s;
  const int D = s.D, H = s.H, R = s.K * s.B;
  const int la = 2 * H + D, lw = la + 3 * D, q = la / 4;
  const size_t n = (size_t)R * q;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NT) {
    const int r = (int)(i / q), c = 4 * (int)(i % q);
    const float* src = a.work + (size_t)r * lw + (c < 2 * H ? c : c + 2 * D);
    *reinterpret_cast<float4*>(a.rows + ((size_t)(t - 1) * R + r) * la + c) =
        __ldcg(reinterpret_cast<const float4*>(src));
  }
}

template <class Rt>  // the route
__device__ __forceinline__ void scan_fwd(const FwdArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const Dims& s = a.s;
  const int D = s.D, H = s.H, R = s.K * s.B;
  const int la = 2 * H + D, lw = la + 3 * D;
  float* A = a.work;
  float* G = A + la;
  float* N = G + D;
  float* S = N + D;
  const Weights& w = a.w;
  unsigned target = 0;
  for (int t = 0; t < s.T; ++t) {
    if (t > 0) {
      const float* Z = a.z_traj + (size_t)(t - 1) * R * D;
      Job p1[1] = {{{Z, D}, {w.w1, D}, R, la, D, {}}};
      p1[0].ep = store_to(A, lw, w.b1, la);
      p1[0].ep.relu_cols = 2 * H;
      run_jobs<Rt, tf32x3::B_NK>(p1, 1, smem);
      grid_sync(a.bar, target);
      Job p2[2] = {{{A, lw}, {w.wg2, H}, R, D, H, store_to(G, lw, w.bg2, D)},
                   {{A + H, lw}, {w.wn2, H}, R, D, H, store_to(N, lw, w.bn2, D)}};
      run_jobs<Rt, tf32x3::B_NK>(p2, 2, smem);
      grid_sync(a.bar, target);
      Job p3[1] = {{{N, lw}, {w.ws, D}, R, D, D, store_to(S, lw, w.bs, D)}};
      run_jobs<Rt, tf32x3::B_NK>(p3, 1, smem);
      if (a.rows != nullptr) copy_fwd_rows(a, t);
      grid_sync(a.bar, target);
    }
    fwd_elementwise(a, t, smem);
    if (t + 1 < s.T) grid_sync(a.bar, target);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float *obs_mean, *obs_std, *obs_mask, *glb_mean, *glb_std, *eps,
      *z_traj, *prior_mean, *prior_std;
  const float *g_pm, *g_ps, *g_im, *g_is, *g_smp;
  Weights w;
  float *d_obs_mean, *d_obs_std, *d_glb_mean, *d_glb_std;  // d_glb_*: zeroed
  // Rows ((t-1) K + k) B + b for t >= 1: xs = [h1 | hn | z_nonlin]
  // (2H + D wide), ys = [d_a1 | d_b1 | d_zlin | d_a2 | d_znonlin | d_sraw]
  // (2H + 4D wide), the two sides of the weight-gradient products. Before
  // a step's VJP, ys's d_zlin, d_a2 and d_sraw hold z_lin, gate_2's and
  // z_to_std's pre-activations, which the VJP overwrites.
  float *xs, *ys;
  float* gz;  // 3 x K B x D: the particles' cotangent in 3 parts (zeroed)
  unsigned* bar;
  Dims s;
  // The bf16 route's rows for gtf_wgrad_bf16_kernel (wgrad_bf16.cuh), as
  // bfloat16 words: xs and ys as above and zs, row r of z_traj; and the
  // bias gradients' f32 sums, nch partials of 2H + 4D (zeroed).
  uint16_t *xs_bf, *ys_bf, *zs_bf;
  float* bias_part;
  int nch;
};

template <bool BF16, int CH = kChunk>  // CH as fwd_elementwise's
__device__ void bwd_elementwise(const BwdArgs& a, int t, float* red) {
  const Dims& s = a.s;
  const int D = s.D, H = s.H, K = s.K, M = s.M, B = s.B;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D;
  const size_t R = (size_t)K * B, RD = R * D;
  float* X = a.xs + (t > 0 ? (size_t)(t - 1) * R * lx : 0);
  float* Y = a.ys + (t > 0 ? (size_t)(t - 1) * R * ly : 0);
  const Lanes ln(K);
  for (int base = blockIdx.x * ln.EPB; base < B * D; base += gridDim.x * ln.EPB) {
    const int e = base + ln.el;
    const bool live = e < B * D;
    const int b = live ? e / D : 0, d = live ? e - b * D : 0;
    const size_t bd = (size_t)b * D + d;
    const size_t tbd = ((size_t)t * B + b) * D + d;
    // The loads of this (b, d) that do not wait on anything come first, so
    // that they are in flight together: a dependent round trip to memory
    // costs microseconds here.
    const float prior_m = __ldg(a.prior_mean + tbd);
    const float prior_s = __ldg(a.prior_std + tbd);
    const float g_smp = __ldg(a.g_smp + tbd), g_im = __ldg(a.g_im + tbd);
    const float g_is = __ldg(a.g_is + tbd), g_pm = __ldg(a.g_pm + tbd);
    const float g_ps = __ldg(a.g_ps + tbd);
    const float gm = __ldg(a.glb_mean + bd), gs = __ldg(a.glb_std + bd);
    float num_o = 0.f, den_o = 0.f;
    add_obs_experts(a.obs_mean, a.obs_std, a.obs_mask, t, M, B, b, D, d,
                    num_o, den_o);

    // Cotangents into z_t -> inference mean/std. A particle's cotangent
    // is the sum of the three partial products of the step after (gz, in
    // order).
    const float gsm = g_smp / (float)K;
    float gg[2] = {0.f, 0.f};  // sum of gz, sum of gz * eps
    for (int c = 0; c < ln.template chunks<CH>(K); ++c) {
      float gzs[CH], ep[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = ln.template particle<CH>(c, i);
        if (live && r < K) {
          const size_t o = ((size_t)r * B + b) * D + d;
          gzs[i] = __ldcg(a.gz + o) + __ldcg(a.gz + RD + o) +
                   __ldcg(a.gz + 2 * RD + o);
          if (BF16) gzs[i] = tf32x3::round_bf16(gzs[i]);
          ep[i] = __ldg(a.eps + (((size_t)t * K + r) * B + b) * D + d);
        }
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (live && ln.template particle<CH>(c, i) < K) {
          const float gz = gzs[i] + gsm;
          gg[0] += gz;
          gg[1] += gz * ep[i];
        }
      }
    }
    group_sum(gg, red, ln);
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
    for (int m = 0; live && ln.kg == 0 && m < M; ++m) {
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
      if (live && ln.kg == 0) {
        a.d_glb_mean[bd] += d_prior_m;
        a.d_glb_std[bd] += d_prior_s;
      }
      continue;
    }

    // PoE2 + mixture, recomputed, then their VJP; each chunk of particles
    // is read again for the VJP (from cache) rather than held across the
    // barrier of the mixture's sums.
    const float p1 = 1.f / (gs * gs + kEps);
    float m3[3] = {0.f, 0.f, 0.f};
    float a2v[CH], zlv[CH], znv[CH], srv[CH];
    auto load_chunk = [&](int c) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = ln.template particle<CH>(c, i);
        if (live && r < K) {
          const size_t row = (size_t)r * B + b;
          const float* y = Y + row * ly;
          a2v[i] = __ldcg(y + la + d);
          zlv[i] = __ldcg(y + 2 * H + d);
          znv[i] = __ldcg(X + row * lx + 2 * H + d);
          srv[i] = __ldcg(y + la + 2 * D + d);
        }
      }
    };
    for (int c = 0; c < ln.template chunks<CH>(K); ++c) {
      load_chunk(c);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (live && ln.template particle<CH>(c, i) < K) {
          float ppm, pps;
          poe2(gm, p1, a2v[i], zlv[i], znv[i], srv[i], s.min_std, ppm, pps);
          m3[0] += ppm;
          m3[1] += pps * pps;
          m3[2] += ppm * ppm;
        }
      }
    }
    group_sum(m3, red, ln);
    const float mu = m3[0] / (float)K;
    const float var = m3[1] / (float)K + m3[2] / (float)K - mu * mu;
    const float ps_val = sqrtf(fmaxf(var, kEps));  // floored at _EPS, as on the TPU
    const float d_var = (var > 0.f) ? d_prior_s / (2.f * ps_val) : 0.f;
    float dg[2] = {0.f, 0.f};  // d_glb_mean, d_p1
    for (int c = 0; c < ln.template chunks<CH>(K); ++c) {
      load_chunk(c);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = ln.template particle<CH>(c, i);
        if (!live || r >= K) continue;
        float* y = Y + ((size_t)r * B + b) * ly;
        const float gate = sigmoid_(a2v[i]);
        const float zl = zlv[i], zn = znv[i], sraw = srv[i];
        const float qm = (1.f - gate) * zl + gate * zn;
        const float qs = softplus_(sraw) + s.min_std;
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
    }
    group_sum(dg, red, ln);
    if (live && ln.kg == 0) {
      a.d_glb_mean[bd] += dg[0];
      a.d_glb_std[bd] +=
          dg[1] * (-2.f * gs / ((gs * gs + kEps) * (gs * gs + kEps)));
    }
  }
}

// The bf16 route: step t's rows (t >= 1) in bfloat16 for the weight
// gradients, 16 bytes a store, and the f32 sums of its cotangents for the
// bias gradients: partial c adds chunk c of the step's rows, column by
// column, rows in order (one thread an item, the same thread every step,
// steps in order: no float atomics). Runs in the phase of the z cotangent's
// product, which writes no row.
__device__ void emit_bf16_rows(const BwdArgs& a, int t) {
  const Dims& s = a.s;
  const int D = s.D, H = s.H, R = s.K * s.B;
  const int lx = 2 * H + D, ly = lx + 3 * D;
  const int qx = lx / 8, qy = ly / 8, per_row = qx + qy + D / 8;
  const size_t r0 = (size_t)(t - 1) * R, step = (size_t)gridDim.x * NT;
  const size_t n = (size_t)R * per_row;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n; i += step) {
    const size_t r = r0 + i / per_row;
    const int q = (int)(i % per_row);
    const float* src;
    uint16_t* dst;
    if (q < qx) {
      src = a.xs + r * lx + 8 * q;
      dst = a.xs_bf + r * lx + 8 * q;
    } else if (q < qx + qy) {
      src = a.ys + r * ly + 8 * (q - qx);
      dst = a.ys_bf + r * ly + 8 * (q - qx);
    } else {
      src = a.z_traj + r * D + 8 * (q - qx - qy);
      dst = a.zs_bf + r * D + 8 * (q - qx - qy);
    }
    const float4 u = __ldcg(reinterpret_cast<const float4*>(src));
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src) + 1);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(tf32x3::bf16x2_(u.x, u.y), tf32x3::bf16x2_(u.z, u.w),
                   tf32x3::bf16x2_(v.x, v.y), tf32x3::bf16x2_(v.z, v.w));
  }
  const int per = (R + a.nch - 1) / a.nch;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
       i < (size_t)a.nch * ly; i += step) {
    const int c = (int)(i / ly), j = (int)(i % ly);
    const int e = min(R, (c + 1) * per);
    float sum = 0.f;
    for (int r = c * per; r < e; ++r) sum += __ldcg(a.ys + (r0 + r) * ly + j);
    a.bias_part[i] += sum;
  }
}

template <class Rt>  // the route
__device__ __forceinline__ void scan_bwd(const BwdArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const Dims& s = a.s;
  const int D = s.D, H = s.H, R = s.K * s.B;
  const int la = 2 * H + D, lx = la, ly = la + 3 * D;
  const int RA = (s.T - 1) * R;  // rows of all steps t >= 1
  const Weights& w = a.w;
  unsigned target = 0;

  // The transition of every step t >= 1 on z_{t-1}, recomputed at once.
  Job q1[1] = {{{a.z_traj, D}, {w.w1, D}, RA, la, D, {}}};
  q1[0].ep = Epi{EP_STORE, w.b1, 2 * H, a.xs, lx, a.ys + 2 * H, ly, 2 * H,
                 nullptr, 0};
  run_jobs<Rt, tf32x3::B_NK>(q1, 1, smem);
  grid_sync(a.bar, target);
  Job q2[2] = {
      {{a.xs, lx}, {w.wg2, H}, RA, D, H, store_to(a.ys + la, ly, w.bg2, D)},
      {{a.xs + H, lx}, {w.wn2, H}, RA, D, H,
       store_to(a.xs + 2 * H, lx, w.bn2, D)}};
  run_jobs<Rt, tf32x3::B_NK>(q2, 2, smem);
  grid_sync(a.bar, target);
  Job q3[1] = {{{a.xs + 2 * H, lx}, {w.ws, D}, RA, D, D,
                store_to(a.ys + la + 2 * D, ly, w.bs, D)}};
  run_jobs<Rt, tf32x3::B_NK>(q3, 1, smem);
  grid_sync(a.bar, target);

  for (int t = s.T - 1; t >= 0; --t) {
    bwd_elementwise<Rt::BF16>(a, t, smem);
    if (t == 0) break;
    grid_sync(a.bar, target);
    float* X = a.xs + (size_t)(t - 1) * R * lx;
    float* Y = a.ys + (size_t)(t - 1) * R * ly;
    // d_znon += d_sraw @ ws;  d_a1 = (d_a2 @ wg2) * (h1 > 0)
    Job p5[2] = {{{Y + la + 2 * D, ly}, {w.ws, D}, R, D, D,
                  store_to(Y + la + D, ly, nullptr, D)},
                 {{Y + la, ly}, {w.wg2, H}, R, H, D,
                  store_to(Y, ly, nullptr, H)}};
    p5[0].ep.mode = EP_ADD;
    p5[1].ep.mode = EP_MASK;
    p5[1].ep.mask = X;
    p5[1].ep.ldm = lx;
    run_jobs<Rt, tf32x3::B_KN>(p5, 2, smem);
    grid_sync(a.bar, target);
    // d_b1 = (d_znon @ wn2) * (hn > 0)
    Job p6[1] = {{{Y + la + D, ly}, {w.wn2, H}, R, H, D,
                  store_to(Y + H, ly, nullptr, H)}};
    p6[0].ep.mode = EP_MASK;
    p6[0].ep.mask = X + H;
    p6[0].ep.ldm = lx;
    run_jobs<Rt, tf32x3::B_KN>(p6, 1, smem);
    grid_sync(a.bar, target);
    // gz = [d_a1 | d_b1 | d_zlin] @ w1, the cotangent of z_{t-1}, as its
    // three 256-deep blocks (gate_1, nonlin_1, z_lin), each into its own
    // partial: three times the tiles of one 768-deep product, so they fill
    // the card; the elementwise phase adds them in order (and on the bf16
    // route rounds their sum).
    const size_t RD = (size_t)R * D;
    Job p7[3] = {
        {{Y, ly}, {w.w1, D}, R, D, H, store_to(a.gz, D, nullptr, D)},
        {{Y + H, ly}, {w.w1 + (size_t)H * D, D}, R, D, H,
         store_to(a.gz + RD, D, nullptr, D)},
        {{Y + 2 * H, ly}, {w.w1 + (size_t)2 * H * D, D}, R, D, D,
         store_to(a.gz + 2 * RD, D, nullptr, D)}};
    for (Job& j : p7) j.ep.keep_f32 = 1;
    run_jobs<Rt, tf32x3::B_KN>(p7, 3, smem);
    if constexpr (Rt::BF16) emit_bf16_rows(a, t);
    grid_sync(a.bar, target);
  }
}

// ---------------------------------------------------------------------------
// Weight gradients
// ---------------------------------------------------------------------------

// dW[i, j] = sum_r X[r, i] Y[r, j] (i < M1, j < N1), db[j] = sum_r Y[r, j],
// over the rows of one split; split z writes dW + z P and db + z P.
struct WJob {
  Operand x, y;
  int M1, N1;
  float *dW, *db;
};

struct WgradArgs {
  WJob jobs[4];
  int R, rows_per_split;
  long long P;
};

template <class WTile>  // the route's weight-gradient tile
__device__ __forceinline__ void wgrad(const WgradArgs& a) {
  extern __shared__ __align__(16) float smem[];
  int j = 0, local = blockIdx.x;
  while (local >= tf32x3::tiles_of<WTile>(a.jobs[j].M1, a.jobs[j].N1)) {
    local -= tf32x3::tiles_of<WTile>(a.jobs[j].M1, a.jobs[j].N1);
    ++j;
  }
  const WJob& jb = a.jobs[j];
  const int mt = (jb.M1 + WTile::BM - 1) / WTile::BM;
  const int m0 = (local % mt) * WTile::BM, n0 = (local / mt) * WTile::BN;
  const int r0 = min(a.R, (int)blockIdx.y * a.rows_per_split);
  const int r1 = min(a.R, r0 + a.rows_per_split);
  const Operand x = {jb.x.p + (size_t)r0 * jb.x.ld, jb.x.ld};
  const Operand y = {jb.y.p + (size_t)r0 * jb.y.ld, jb.y.ld};
  Acc<WTile> acc;
  float cs = 0.f;
  tf32x3::tile_product<WTile, tf32x3::A_KM, tf32x3::B_KN>(
      x, y, jb.M1, jb.N1, r1 - r0, m0, n0, smem, acc, m0 == 0 ? &cs : nullptr);
  float* dW = jb.dW + (size_t)blockIdx.y * a.P;
  const int N1 = jb.N1;
  tf32x3::tile_store<WTile>(acc, jb.M1, N1, m0, n0,
                            [&](int m, int n, float v0, float v1) {
                              *reinterpret_cast<float2*>(dW + (size_t)m * N1 + n) =
                                  make_float2(v0, v1);
                            });
  if (m0 == 0 && threadIdx.x < WTile::BN && n0 + (int)threadIdx.x < N1)
    jb.db[(size_t)blockIdx.y * a.P + n0 + threadIdx.x] = cs;
}

// ---------------------------------------------------------------------------
// The kernels of one route, and their launches
// ---------------------------------------------------------------------------

// f32_scan.cu defines BFVI_SCAN_HELPERS_ONLY: it takes the helpers above
// and builds no kernel of this file.
#if !BFVI_SCAN_HELPERS_ONLY

// The includer defines BFVI_SCAN_BF16 as 1 for the bf16 library
// (bfvi_scan_bf16.cu: the tiled bf16 scans, with the C entry points
// bfvi_scan_fwd_tiled and bfvi_scan_bwd_tiled) and leaves it undefined for
// the float32 kernels (bfvi_scan.cu: bfvi_scan_fwd, bfvi_scan_bwd,
// gtf_wgrad): two libraries, which nvcc builds side by side.
#if BFVI_SCAN_BF16
using Route = Bf16Route;
#define BFVI_KERNEL(name) name##_bf16_tiled_kernel
#define BFVI_ENTRY(name) name##_tiled
#else
using Route = Tf32Route;
#define BFVI_KERNEL(name) name##_kernel
#define BFVI_ENTRY(name) name
#endif

__global__ void __launch_bounds__(NT, 2) BFVI_KERNEL(bfvi_scan_fwd)(FwdArgs a) {
  scan_fwd<Route>(a);
}

__global__ void __launch_bounds__(NT, 2) BFVI_KERNEL(bfvi_scan_bwd)(BwdArgs a) {
  scan_bwd<Route>(a);
}

#if !BFVI_SCAN_BF16
__global__ void __launch_bounds__(NT, 2) gtf_wgrad_kernel(WgradArgs a) {
  wgrad<tf32x3::LargePromoted>(a);
}
#endif

cudaError_t set_smem(const void* kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tf32x3::kSmemBytes);
}

// A cooperative launch of as many CTAs as the device holds at once (two
// per SM), or fewer where no phase has more work (`work` tiles or blocks).
// If the device cannot hold the grid, the launch fails: there is no other
// path.
template <typename Args>
cudaError_t launch_coop(void (*kern)(Args), int work, cudaStream_t st,
                        Args* args) {
  cudaError_t err = set_smem((const void*)kern);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      tf32x3::kSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = work < per_sm * sms ? (work > 0 ? work : 1) : per_sm * sms;
  void* params[] = {args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT),
                                    params, tf32x3::kSmemBytes, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// CTAs that give every (b, d) of an elementwise phase its threads.
int elementwise_blocks(int n, int K) {
  const int per_cta = K > 1 ? NT / 2 : NT;  // as Lanes
  return (n + per_cta - 1) / per_cta;
}

Weights make_weights(const float* w1, const float* b1, const float* wg2,
                     const float* bg2, const float* wn2, const float* bn2,
                     const float* ws, const float* bs) {
  return Weights{w1, b1, wg2, bg2, wn2, bn2, ws, bs};
}

#endif  // !BFVI_SCAN_HELPERS_ONLY

}  // namespace

#if !BFVI_SCAN_HELPERS_ONLY
extern "C" {

// The forward scan. bfvi_scan_fwd_tiled (the bf16 library) also takes
// `rows`: null, or the (T-1) K B rows [h1 | hn | z_nonlin] that it writes
// for its activations.
int BFVI_ENTRY(bfvi_scan_fwd)(
    const float* obs_mean, const float* obs_std, const float* obs_mask,
    const float* glb_mean, const float* glb_std, const float* w1,
    const float* b1, const float* wg2, const float* bg2, const float* wn2,
    const float* bn2, const float* ws, const float* bs, const float* eps,
    float* prior_mean, float* prior_std, float* infer_mean, float* infer_std,
    float* samples, float* z_traj, float* work, unsigned* bar, int T, int M,
    int B, int K, int D, int H, float min_std, void* stream
#if BFVI_SCAN_BF16
    , float* rows
#endif
) {
  FwdArgs a;
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.w = make_weights(w1, b1, wg2, bg2, wn2, bn2, ws, bs);
  a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.infer_mean = infer_mean; a.infer_std = infer_std;
  a.samples = samples; a.z_traj = z_traj; a.work = work; a.bar = bar;
  a.rows = nullptr;
#if BFVI_SCAN_BF16
  a.rows = rows;
#endif
  a.s = Dims{T, M, B, K, D, H, min_std};
  const int R = K * B, la = 2 * H + D;
  int work_items = elementwise_blocks(B * D, K);
  if (T > 1) {
    const int p1[1] = {la}, p2[2] = {D, D}, p3[1] = {D};
    work_items = max_(work_items, max_(phase_tiles<Route>(R, p1, 1),
                                       max_(phase_tiles<Route>(R, p2, 2),
                                            phase_tiles<Route>(R, p3, 1))));
  }
  return (int)launch_coop(BFVI_KERNEL(bfvi_scan_fwd), work_items,
                          (cudaStream_t)stream, &a);
}

// The backward scan. bfvi_scan_bwd_tiled (the bf16 library) also takes
// the rows in bfloat16 that it writes for gtf_wgrad_bf16_kernel (xs_bf,
// ys_bf as xs and ys, zs_bf as z_traj's first (T-1) K B rows) and the
// bias gradients' f32 sums of its cotangents, nch partials of 2H + 4D
// (bias_part, zeroed).
int BFVI_ENTRY(bfvi_scan_bwd)(
    const float* obs_mean, const float* obs_std, const float* obs_mask,
    const float* glb_mean, const float* glb_std, const float* w1,
    const float* b1, const float* wg2, const float* bg2, const float* wn2,
    const float* bn2, const float* ws, const float* bs, const float* eps,
    const float* z_traj, const float* prior_mean, const float* prior_std,
    const float* g_pm, const float* g_ps, const float* g_im,
    const float* g_is, const float* g_smp, float* d_obs_mean,
    float* d_obs_std, float* d_glb_mean, float* d_glb_std, float* xs,
    float* ys, float* gz, unsigned* bar, int T, int M, int B, int K, int D,
    int H, float min_std, void* stream
#if BFVI_SCAN_BF16
    , uint16_t* xs_bf, uint16_t* ys_bf, uint16_t* zs_bf, float* bias_part,
    int nch
#endif
) {
  BwdArgs a;
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.z_traj = z_traj; a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.g_pm = g_pm; a.g_ps = g_ps; a.g_im = g_im; a.g_is = g_is; a.g_smp = g_smp;
  a.w = make_weights(w1, b1, wg2, bg2, wn2, bn2, ws, bs);
  a.d_obs_mean = d_obs_mean; a.d_obs_std = d_obs_std;
  a.d_glb_mean = d_glb_mean; a.d_glb_std = d_glb_std;
  a.xs = xs; a.ys = ys; a.gz = gz; a.bar = bar;
  a.s = Dims{T, M, B, K, D, H, min_std};
  a.xs_bf = a.ys_bf = a.zs_bf = nullptr;
  a.bias_part = nullptr;
  a.nch = 0;
#if BFVI_SCAN_BF16
  a.xs_bf = xs_bf; a.ys_bf = ys_bf; a.zs_bf = zs_bf;
  a.bias_part = bias_part; a.nch = nch;
#endif
  const int R = K * B, RA = (T - 1) * R, la = 2 * H + D;
  int work_items = elementwise_blocks(B * D, K);
  if (T > 1) {
    const int q1[1] = {la}, q2[2] = {D, D}, q3[1] = {D};
    const int p5[2] = {D, H}, p6[1] = {H}, p7[3] = {D, D, D};
    const int phases[] = {
        phase_tiles<Route>(RA, q1, 1), phase_tiles<Route>(RA, q2, 2),
        phase_tiles<Route>(RA, q3, 1), phase_tiles<Route>(R, p5, 2),
        phase_tiles<Route>(R, p6, 1), phase_tiles<Route>(R, p7, 3)};
    for (int n : phases) work_items = max_(work_items, n);
  }
  return (int)launch_coop(BFVI_KERNEL(bfvi_scan_bwd), work_items,
                          (cudaStream_t)stream, &a);
}

#if !BFVI_SCAN_BF16
// The GTF weight gradients from the R rows that bfvi_scan_bwd wrote (and
// z_traj, whose first R rows are the input side of dW1), into `splits`
// partials laid out as [dW1 (D x la) | db1 | dWg2 (H x D) | dbg2 |
// dWn2 (H x D) | dbn2 | dWs (D x D) | dbs] each, dW in (in, out) layout.
int gtf_wgrad(const float* z_traj, const float* xs, const float* ys,
              float* partial, int splits, int R, int D, int H, void* stream) {
  const int la = 2 * H + D, lx = la, ly = la + 3 * D;
  WgradArgs a;
  a.P = (long long)D * la + la + 2LL * (H * D + D) + D * D + D;
  float* dW1 = partial;
  float* dWg2 = dW1 + (size_t)D * la + la;
  float* dWn2 = dWg2 + (size_t)H * D + D;
  float* dWs = dWn2 + (size_t)H * D + D;
  a.jobs[0] = WJob{{z_traj, D}, {ys, ly}, D, la, dW1, dW1 + (size_t)D * la};
  a.jobs[1] = WJob{{xs, lx}, {ys + la, ly}, H, D, dWg2, dWg2 + (size_t)H * D};
  a.jobs[2] = WJob{{xs + H, lx}, {ys + la + D, ly}, H, D, dWn2,
                   dWn2 + (size_t)H * D};
  a.jobs[3] = WJob{{xs + 2 * H, lx}, {ys + la + 2 * D, ly}, D, D, dWs,
                   dWs + (size_t)D * D};
  a.R = R;
  a.rows_per_split = (R + splits - 1) / splits;
  // The weight-gradient tile is 128 x 64, as the wrapper's split count
  // assumes (ops/cuda/bfvi_scan.py, WGRAD_TILE).
  using WTile = tf32x3::LargePromoted;
  static_assert(WTile::BM == 128 && WTile::BN == 64,
                "the wrapper's weight-gradient tile");
  int tiles = 0;
  for (const WJob& j : a.jobs) tiles += tf32x3::tiles_of<WTile>(j.M1, j.N1);
  cudaError_t err = set_smem((const void*)gtf_wgrad_kernel);
  if (err != cudaSuccess) return (int)err;
  gtf_wgrad_kernel<<<dim3(tiles, splits), NT, tf32x3::kSmemBytes,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"

#endif  // !BFVI_SCAN_HELPERS_ONLY
