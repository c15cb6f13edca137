// One step of the evaluation's sampled filtering pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of multimodal_dmm_tpu/ops/pallas/poe_cell.py
// (`_kernel`, called by `poe_sample_cell`) and, fused in front of it, the
// elementwise part of the JAX package's `MultiDMM._z_next`
// (multimodal_dmm_tpu/models/dmm.py: `gtf_apply_packed`'s tail,
// `product_of_experts_pair`, `mean_of_experts`), which the JAX package runs
// outside any Pallas kernel. Two kernels, from one template:
//
//   poe_sample_cell_kernel  <- `_kernel`: a precision-space PoE of the
//     positive-std prior with M masked, signed-std experts (variance floor
//     1e-8; a total precision below 1e-6 gives mean 0 and std 1e3), then
//     z_k = mean + eps_k * std for K particles, then their mean. The pass's
//     first step and every direct caller.
//   poe_sample_step_kernel  <- `_z_next` after its products, then `_kernel`:
//     from the four product outputs of the previous particles (z_lin,
//     gate_pre, z_nonlin, std_pre; ops/cuda/poe_cell.py:
//     poe_sample_step_ref), for each particle row (k, b)
//       q_mean = (1 - sigmoid(gate_pre)) z_lin + sigmoid(gate_pre) z_nonlin,
//       q_std = softplus(std_pre) + min_std (torch's threshold of 20);
//     the pair PoE of the global prior (row b) with (q_mean, q_std), where a
//     row with a NaN in any of its D variances drops out (ops/poe.py:
//     product_of_experts_pair); the moment-matched mixture over the K rows
//     (a row whose pair std has a NaN gives zero moments and still counts in
//     the 1/K weight, ops/poe.py: mean_of_experts): the conditional prior;
//     then the cell above on it. Every later step of the pass.
//
// Everything is float32 and rounds where PyTorch's separate elementwise ops
// round: the library is built with -fmad=false (ops/cuda/_build.py), so no
// product and sum are contracted into one FMA.
//
// Layout: the products are rows of D floats, particle row (k, b) at
// (k B + b) ld, where ld is D, or 2H + D for z_lin (a view of the first
// product's output, read in place); prior / global prior (B, D);
// obs_mean / obs_std (M, B, D); obs_mask (M, B); eps and z (K, B, D);
// prior_* (step only), infer_*, sample (B, D).
//
// What bounds it on the H100: device memory. At the Weizmann evaluation's
// step, (M, K, B, D) = (3, 200, 25, 256), it reads five (K, B, D) tensors and
// writes one, 6 x 5.1 MB, about 9 us at 3.35 TB/s; it does a few dozen
// operations a byte's worth of elements. The sums over K are the only
// coupling between particles, and the NaN flags the only coupling inside a
// row.
//
// Design. One thread block cluster of C CTAs (C <= 8) owns a batch column b;
// CTA r owns particles [r kc, r kc + kc) and stages their rows, kb at a time
// (all of them at the apps' shapes), into shared memory: one 1-D TMA bulk
// copy a row and tensor, issued by one warp, completed on an mbarrier (rows
// whose address or size is no multiple of 16 bytes, as at the spirals
// widths, are copied by the CTA's threads instead). A thread works on one
// column of every G-th row, so consecutive threads read consecutive floats
// and a thread's rows are independent (unrolled for ILP). The step:
//   1. the tail's std in place of std_pre; a NaN variance flags its row
//      (a shared-memory OR, set only on a NaN);
//   2. the tail's mean and the pair PoE with the global prior, in place of
//      z_lin and gate_pre, flagging a row whose pair std has a NaN; then
//      eps is requested into z_nonlin's slot, so its copy runs under
//      steps 3-4 (four staged tensors: two CTAs fit an SM at the apps'
//      shapes);
//   3. the mixture's three sums a column (mean, std^2, mean^2): each group
//      of threads sums its rows in order, the groups are added in order,
//      and after a cluster barrier every CTA adds the C CTAs' partials in
//      rank order through distributed shared memory (ld.shared::cluster):
//      all CTAs hold the same sums, in the same order in every run, with
//      no atomics;
//   4. every CTA forms the prior and the cell's infer for its whole column
//      (CTA 0 writes them), writes z for its rows and sums them the same
//      way for the sample, which CTA 0 reads from its peers after a second
//      cluster barrier.
// The cell runs step 4 alone on the given prior, its eps requested first.
// The plan (C, kc, kb, G, shared memory) comes from the wrapper
// (ops/cuda/poe_cell.py: poe_plan), which this file checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // a CTA's dynamic shared memory on the H100
constexpr float kEps = 1e-8f;     // variance floor (_EPS)
constexpr float kPrecFloor = 1e-6f;

struct Args {
  // step: the previous particles' product outputs, rows as above
  const float* z_lin;
  const float* gate_pre;
  const float* z_nonlin;
  const float* std_pre;
  int ld_lin;
  // step: the global prior; cell: the prior
  const float* p_mean;
  const float* p_std;
  const float* obs_mean;
  const float* obs_std;
  const float* obs_mask;
  const float* eps;
  float* prior_mean;  // step only
  float* prior_std;
  float* infer_mean;
  float* infer_std;
  float* z;
  float* sample;
  float min_std;
  int M, B, K, D;
  int C, kc, kb, groups, lanes, smem, tma;
};

// Shared memory, in floats from the start: the staged rows (`rows` tensors
// of kb rows, D each: the step's z_lin, gate_pre, z_nonlin, std_pre, eps
// taking z_nonlin's slot once the tail has read it; the cell's eps),
// acc[3][G][D], zacc[G][D], gnum[D], gprec[D], im[D], is[D], bad[kb] and
// drop[kb] (ints), then two mbarriers at a 16-byte boundary.
__host__ __device__ inline int stage_rows(bool step) { return step ? 4 : 1; }

__host__ __device__ inline int bar_offset(bool step, int D, int G, int kb) {
  const int floats = stage_rows(step) * kb * D + 4 * G * D + 4 * D + 2 * kb;
  return (4 * floats + 15) / 16 * 16;
}

__host__ __device__ inline int smem_bytes(bool step, int D, int G, int kb) {
  return bar_offset(step, D, G, kb) + 16;
}

__device__ __forceinline__ float sign_(float x) {
  return (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
}

// sign(s) / (s^2 + 1e-8), the precision of an expert of std s: the
// reciprocal, correctly rounded, times +-1 or 0 is that quotient exactly.
__device__ __forceinline__ float precision(float s) {
  return sign_(s) * (1.f / (s * s + kEps));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sum, in rank order, of the float at `local` (this CTA's shared
// address) in the shared memory of cluster CTAs 0 .. C - 1: the C loads are
// issued before the first add.
__device__ __forceinline__ float sum_peers(uint32_t local, int C) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < C) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote) : "r"(local), "r"(r));
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                   : "=f"(v[r]) : "r"(remote) : "memory");
    }
  }
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < C) t = t + v[r];
  return t;
}

// Waits, with every thread of the warp, for phase `parity` of the mbarrier
// at `bar`; a wait still open after 10 s traps, so a fault ends the launch
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

struct Smem {
  float* stage;
  float* acc;
  float* zacc;
  float* gnum;
  float* gprec;
  float* im;
  float* is;
  int* bad;   // a row's pair-PoE flag: a NaN in its variances
  int* drop;  // a row's mixture flag: a NaN in its pair std
  uint32_t bar_prod, bar_eps;
};

template <bool kStep>
__device__ __forceinline__ Smem carve(float* sm, const Args& a) {
  const int D = a.D, G = a.groups, kb = a.kb;
  Smem s;
  s.stage = sm;
  s.acc = sm + stage_rows(kStep) * kb * D;
  s.zacc = s.acc + 3 * G * D;
  s.gnum = s.zacc + G * D;
  s.gprec = s.gnum + D;
  s.im = s.gprec + D;
  s.is = s.im + D;
  s.bad = reinterpret_cast<int*>(s.is + D);
  s.drop = s.bad + kb;
  const uint32_t bar = smem_addr(sm) + bar_offset(kStep, D, G, kb);
  s.bar_prod = bar;
  s.bar_eps = bar + 8;
  return s;
}

// Rows [0, nr) of a chunk (global particle k_first + i) of `nt` tensors,
// column b, into the staging slots slot0 .. slot0 + nt - 1 (slot s, row i
// at stage + (s kb + i) D): the four products (nt = 4) or eps. With TMA
// one warp issues a bulk copy a row and tensor, completing on `bar`;
// without, every thread copies elements. Called by every thread;
// `stage_wait` follows.
__device__ void stage_load(const Args& a, const Smem& s, int slot0, int nt,
                           int b, int k_first, int nr, uint32_t bar) {
  const int D = a.D, B = a.B;
  const float* const srcs[4] = {a.z_lin, a.gate_pre, a.z_nonlin, a.std_pre};
  const int lds[4] = {a.ld_lin, D, D, D};
  if (a.tma) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            ::"r"(bar), "r"(nt * nr * D * 4) : "memory");
      __syncwarp();
      for (int j = threadIdx.x; j < nt * nr; j += 32) {
        const int t = j / nr, i = j - t * nr;
        const float* src =
            (nt == 1 ? a.eps : srcs[t]) +
            ((size_t)(k_first + i) * B + b) * (nt == 1 ? D : lds[t]);
        const uint32_t dst = smem_addr(s.stage + ((size_t)(slot0 + t) * a.kb
                                                  + i) * D);
        asm volatile(
            "cp.async.bulk.shared::cluster.global"
            ".mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(dst), "l"(src), "r"(D * 4), "r"(bar) : "memory");
      }
    }
  } else {
    const int per = nr * D;
    for (int j = threadIdx.x; j < nt * per; j += kThreads) {
      const int t = j / per, rem = j - t * per;
      const int i = rem / D, d = rem - i * D;
      const float* src = nt == 1 ? a.eps : srcs[t];
      const int ld = nt == 1 ? D : lds[t];
      s.stage[((size_t)(slot0 + t) * a.kb + i) * D + d] =
          __ldg(src + ((size_t)(k_first + i) * B + b) * ld + d);
    }
  }
}

__device__ __forceinline__ void stage_wait(const Args& a, uint32_t bar,
                                           int& parity) {
  if (a.tma) {
    mbar_wait(bar, parity);
    parity ^= 1;
  } else {
    __syncthreads();
  }
}

// Before staging slots are written again: every thread's reads and writes
// of them done, and ordered before the async proxy's writes.
__device__ __forceinline__ void stage_release() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// A thread (g, dl) of the CTA's G groups of L lanes works on columns dl,
// dl + L, ... of rows g, g + G, ...: consecutive threads on consecutive
// floats of a row. Threads beyond G L (L = D < 256) idle there.
template <bool kStep>
__device__ void poe_body(const Args& a) {
  extern __shared__ __align__(128) float sm[];
  const Smem s = carve<kStep>(sm, a);
  const int D = a.D, K = a.K, B = a.B, C = a.C, kb = a.kb;
  const int G = a.groups, L = a.lanes;
  const int rank = (int)cluster_rank();
  const int b = blockIdx.x / C;
  const int k0 = rank * a.kc;
  const int n = min(K, k0 + a.kc) - k0;  // >= 1 (the plan's)
  const int tid = threadIdx.x;
  const int g = tid / L, dl = tid - g * L;
  const bool active = g < G;
  const int eps_slot = kStep ? 2 : 0;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(s.bar_prod) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(s.bar_eps) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int par_prod = 0, par_eps = 0;
  // eps's first rows, where its slot is free from the start (the cell);
  // the step's, as soon as the tail has read z_nonlin (one chunk).
  bool eps_issued = !kStep;
  if (!kStep) stage_load(a, s, eps_slot, 1, b, k0, min(kb, n), s.bar_eps);

  // -- the conditional prior (step) ----------------------------------------
  if (kStep) {
    // The global prior's row b: its NaN flag over D, each column's
    // precision and mean term.
    bool nan1 = false;
    for (int d = tid; d < D; d += kThreads) {
      const float gs = __ldg(a.p_std + (size_t)b * D + d);
      nan1 |= isnan(gs * gs + kEps);
    }
    const bool bad1 = __syncthreads_or(nan1);
    for (int d = tid; d < D; d += kThreads) {
      const float gs = __ldg(a.p_std + (size_t)b * D + d);
      const float gm = __ldg(a.p_mean + (size_t)b * D + d);
      const float prec = bad1 ? 0.f : precision(gs);
      s.gnum[d] = (bad1 ? 0.f : gm) * prec;
      s.gprec[d] = prec;
    }
    for (int j = tid; j < 3 * G * D; j += kThreads) s.acc[j] = 0.f;

    for (int c0 = 0; c0 < n; c0 += kb) {
      const int nr = min(kb, n - c0);
      if (c0 > 0) stage_release();
      for (int i = tid; i < nr; i += kThreads) s.bad[i] = s.drop[i] = 0;
      stage_load(a, s, 0, 4, b, k0 + c0, nr, s.bar_prod);
      __syncthreads();  // the flags cleared
      stage_wait(a, s.bar_prod, par_prod);
      float* zl = s.stage;
      float* gp = s.stage + (size_t)kb * D;
      const float* zn = s.stage + (size_t)2 * kb * D;
      float* sp = s.stage + (size_t)3 * kb * D;
      // The tail's std in place of std_pre; a row with a NaN variance
      // raises its flag.
      if (active) {
        for (int d = dl; d < D; d += L) {
#pragma unroll 4
          for (int i = g; i < nr; i += G) {
            const size_t at = (size_t)i * D + d;
            const float x = sp[at];
            const float q = (x > 20.f ? x : log1pf(expf(x))) + a.min_std;
            sp[at] = q;
            if (isnan(q * q + kEps)) atomicOr(s.bad + i, 1);
          }
        }
      }
      __syncthreads();
      // The tail's mean and the pair PoE with the global prior: the pair's
      // mean and std in place of z_lin and gate_pre.
      if (active) {
        for (int d = dl; d < D; d += L) {
          const float gnum = s.gnum[d], gprec = s.gprec[d];
#pragma unroll 4
          for (int i = g; i < nr; i += G) {
            const size_t at = (size_t)i * D + d;
            const bool bad = s.bad[i] != 0;
            const float gate = 1.f / (1.f + expf(-gp[at]));
            const float qm = (1.f - gate) * zl[at] + gate * zn[at];
            const float prec = bad ? 0.f : precision(sp[at]);
            const float num = gnum + (bad ? 0.f : qm) * prec;
            const float den = gprec + prec;
            const bool low = den < kPrecFloor;
            const float safe = low ? 1.f : den;
            const float ps = low ? 1e3f : 1.f / sqrtf(safe);
            zl[at] = low ? 0.f : num / safe;
            gp[at] = ps;
            if (isnan(ps)) atomicOr(s.drop + i, 1);
          }
        }
      }
      stage_release();
      if (nr == n) {  // one chunk: eps into z_nonlin's slot now
        stage_load(a, s, eps_slot, 1, b, k0, nr, s.bar_eps);
        eps_issued = true;
      }
      // The mixture's three sums, group g's rows in order, a column a
      // thread; a dropped row adds zero moments.
      if (active) {
        for (int d = dl; d < D; d += L) {
          float* am = s.acc + (size_t)g * D + d;
          float* av = am + (size_t)G * D;
          float* aq = av + (size_t)G * D;
          float tm = *am, tv = *av, tq = *aq;
#pragma unroll 4
          for (int i = g; i < nr; i += G) {
            const bool drop = s.drop[i] != 0;
            const float pm = drop ? 0.f : zl[(size_t)i * D + d];
            const float ps = drop ? 0.f : gp[(size_t)i * D + d];
            tm = tm + pm;
            tv = tv + ps * ps;
            tq = tq + pm * pm;
          }
          *am = tm;
          *av = tv;
          *aq = tq;
        }
      }
    }
    __syncthreads();
    // The CTA's partials: groups added in order, into group 0's slots.
    for (int d = tid; d < D; d += kThreads) {
      for (int j = 0; j < 3; ++j) {
        float* p = s.acc + (size_t)j * G * D + d;
        float t = p[0];
        for (int gg = 1; gg < G; ++gg) t = t + p[(size_t)gg * D];
        p[0] = t;
      }
    }
    cluster_sync();  // every CTA's partials written
  }

  // -- the prior, the cell's PoE: every CTA, its whole column ---------------
  for (int d = tid; d < D; d += kThreads) {
    float pm, ps;
    if (kStep) {
      float tot[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        tot[j] = sum_peers(smem_addr(s.acc + (size_t)j * G * D + d), C);
      const float mean = tot[0] / (float)K;
      const float var =
          (tot[1] / (float)K + tot[2] / (float)K) - mean * mean;
      pm = mean;
      ps = sqrtf(var < 0.f ? 0.f : var);  // NaN stays NaN, as torch.clamp
      if (rank == 0) {
        a.prior_mean[(size_t)b * D + d] = pm;
        a.prior_std[(size_t)b * D + d] = ps;
      }
    } else {
      pm = __ldg(a.p_mean + (size_t)b * D + d);
      ps = __ldg(a.p_std + (size_t)b * D + d);
    }
    const float prec_p = 1.f / (ps * ps + kEps);  // the prior's std is >= 0
    float num = pm * prec_p, den = prec_p;
    for (int m = 0; m < a.M; ++m) {
      if (__ldg(a.obs_mask + (size_t)m * B + b) > 0.f) {
        const size_t at = ((size_t)m * B + b) * D + d;
        const float prec = precision(__ldg(a.obs_std + at));
        num = num + __ldg(a.obs_mean + at) * prec;
        den = den + prec;
      }
    }
    const bool low = den < kPrecFloor;
    const float safe = low ? 1.f : den;
    const float im = low ? 0.f : num / safe;
    const float is = low ? 1e3f : 1.f / sqrtf(safe);
    s.im[d] = im;
    s.is[d] = is;
    if (rank == 0) {
      a.infer_mean[(size_t)b * D + d] = im;
      a.infer_std[(size_t)b * D + d] = is;
    }
  }
  for (int j = tid; j < G * D; j += kThreads) s.zacc[j] = 0.f;
  __syncthreads();

  // -- the CTA's particles and their sum ------------------------------------
  for (int c0 = 0; c0 < n; c0 += kb) {
    const int nr = min(kb, n - c0);
    if (c0 > 0 || !eps_issued) {
      stage_release();
      stage_load(a, s, eps_slot, 1, b, k0 + c0, nr, s.bar_eps);
    }
    stage_wait(a, s.bar_eps, par_eps);
    if (active) {
      const float* e = s.stage + (size_t)eps_slot * kb * D;
      for (int d = dl; d < D; d += L) {
        const float im = s.im[d], is = s.is[d];
        float* acc = s.zacc + (size_t)g * D + d;
        float t = *acc;
#pragma unroll 4
        for (int i = g; i < nr; i += G) {
          const float zk = im + e[(size_t)i * D + d] * is;
          a.z[((size_t)(k0 + c0 + i) * B + b) * D + d] = zk;
          t = t + zk;
        }
        *acc = t;
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float t = s.zacc[d];
    for (int gg = 1; gg < G; ++gg) t = t + s.zacc[(size_t)gg * D + d];
    s.zacc[d] = t;
  }
  cluster_sync();  // every CTA's particle sums written
  if (rank == 0) {
    for (int d = tid; d < D; d += kThreads) {
      a.sample[(size_t)b * D + d] =
          sum_peers(smem_addr(s.zacc + d), C) / (float)K;
    }
  }
  cluster_sync();  // no CTA leaves while CTA 0 reads its sums
}

__global__ void __launch_bounds__(kThreads, 2)
    poe_sample_cell_kernel(const __grid_constant__ Args a) {
  poe_body<false>(a);
}

__global__ void __launch_bounds__(kThreads, 2)
    poe_sample_step_kernel(const __grid_constant__ Args a) {
  poe_body<true>(a);
}

// Reads the plan (C, kc, kb, groups, lanes, smem, tma) into `a`, checks it
// against the shapes and this file's layout, and launches B clusters of C
// CTAs. Returns a CUDA error code; cudaErrorInvalidValue for a plan or
// input that the kernel does not take.
cudaError_t launch(void (*kern)(Args), bool step, Args& a, const int* plan,
                   cudaStream_t st) {
  a.C = plan[0];
  a.kc = plan[1];
  a.kb = plan[2];
  a.groups = plan[3];
  a.lanes = plan[4];
  a.smem = plan[5];
  a.tma = plan[6];
  const int lanes = a.D < kThreads ? a.D : kThreads;
  if (a.M < 0 || a.B < 1 || a.K < 1 || a.D < 1 || a.C < 1 ||
      a.C > kMaxCluster || a.kc < 1 || (a.C - 1) * a.kc >= a.K ||
      a.C * a.kc < a.K || a.kb < 1 || a.kb > a.kc || a.lanes != lanes ||
      a.groups != kThreads / lanes ||
      a.smem != smem_bytes(step, a.D, a.groups, a.kb) || a.smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (a.tma) {
    const float* rows[5] = {a.eps, a.z_lin, a.gate_pre, a.z_nonlin,
                            a.std_pre};
    for (int i = 0; i < (step ? 5 : 1); ++i)
      if (reinterpret_cast<uintptr_t>(rows[i]) % 16)
        return cudaErrorInvalidValue;
    if (a.D % 4 || (step && a.ld_lin % 4)) return cudaErrorInvalidValue;
  }
  if ((long long)a.B * a.C > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * a.C));
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

}  // namespace

extern "C" {

// The cell: prior (B, D) given. Returns the launch's CUDA error code.
int poe_sample_cell(const float* prior_mean, const float* prior_std,
                    const float* obs_mean, const float* obs_std,
                    const float* obs_mask, const float* eps,
                    float* infer_mean, float* infer_std, float* z,
                    float* sample, int M, int B, int K, int D,
                    const int* plan, void* stream) {
  Args a = {};
  a.p_mean = prior_mean;
  a.p_std = prior_std;
  a.obs_mean = obs_mean;
  a.obs_std = obs_std;
  a.obs_mask = obs_mask;
  a.eps = eps;
  a.infer_mean = infer_mean;
  a.infer_std = infer_std;
  a.z = z;
  a.sample = sample;
  a.M = M;
  a.B = B;
  a.K = K;
  a.D = D;
  return (int)launch(poe_sample_cell_kernel, false, a, plan,
                     (cudaStream_t)stream);
}

// The step: the previous particles' product outputs (z_lin with row stride
// ld_lin), the global prior (B, D). Returns the launch's CUDA error code.
int poe_sample_step(const float* z_lin, int ld_lin, const float* gate_pre,
                    const float* z_nonlin, const float* std_pre,
                    const float* glb_mean, const float* glb_std,
                    const float* obs_mean, const float* obs_std,
                    const float* obs_mask, const float* eps,
                    float* prior_mean, float* prior_std, float* infer_mean,
                    float* infer_std, float* z, float* sample, float min_std,
                    int M, int B, int K, int D, const int* plan,
                    void* stream) {
  Args a = {};
  a.z_lin = z_lin;
  a.ld_lin = ld_lin;
  a.gate_pre = gate_pre;
  a.z_nonlin = z_nonlin;
  a.std_pre = std_pre;
  a.p_mean = glb_mean;
  a.p_std = glb_std;
  a.obs_mean = obs_mean;
  a.obs_std = obs_std;
  a.obs_mask = obs_mask;
  a.eps = eps;
  a.prior_mean = prior_mean;
  a.prior_std = prior_std;
  a.infer_mean = infer_mean;
  a.infer_std = infer_std;
  a.z = z;
  a.sample = sample;
  a.min_std = min_std;
  a.M = M;
  a.B = B;
  a.K = K;
  a.D = D;
  return (int)launch(poe_sample_step_kernel, true, a, plan,
                     (cudaStream_t)stream);
}

}  // extern "C"
