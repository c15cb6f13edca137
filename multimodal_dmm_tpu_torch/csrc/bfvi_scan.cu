// BFVI filtering scan, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of multimodal_dmm_tpu/ops/pallas/bfvi_scan.py:
//   bfvi_scan_fwd_kernel  <- bfvi_scan_pallas / _fwd_kernel
//   bfvi_scan_bwd_kernel  <- bfvi_scan_pallas_bwd / _bwd_kernel (hand-derived VJP)
//   gtf_wgrad_kernel      <- the weight-gradient products of _bwd_kernel
// and computes what they compute, in float32.
//
// Layout (one scan direction; the caller flips time for backward passes):
//   obs_mean/obs_std (T, M, B, D), obs_mask (T, M, B), glb_mean/glb_std (B, D),
//   eps and z_traj (T, K, B, D), the other outputs (T, B, D).
//   GTF weights in (in, out) layout for the products of the transition:
//     w1 (D, 2H+D) = [gate_1 | nonlin_1 | z_lin], b1 (2H+D),
//     wg2 (H, D), wn2 (H, D), ws (D, D) with their biases;
//   the backward also takes the (out, in) layouts (PyTorch's own), which are
//   the matrices its input-gradient products need: w1t (2H+D, D),
//   wg2t (D, H), wn2t (D, H), wst (D, D).
//
// Design. Batch columns are independent through time, so each CTA owns one
// column b and runs the whole time loop itself; this replaces the TPU's
// sequential grid. The K particle rows of that column live in dynamic shared
// memory with every activation of one step (K x (5D + 2H) floats forward,
// K x (6D + 2H) backward: 179 KB / 205 KB at K = 25, D = H = 256). The GTF
// weights (1.5 MB at D = H = 256) do not fit in shared memory as they fitted
// in VMEM, so every product streams them from L2, where all CTAs share them.
// A product gives each thread one output column and keeps its K row sums in
// registers; activations are read as float4 broadcasts from shared memory.
//
// The TPU kernel carries the weight gradients in VMEM from one grid step to
// the next. A CTA here cannot hold them (1.6 MB), so the backward kernel
// writes, for every particle row of every step, the activations and
// cotangents that the weight gradients are products of (the input side of
// dW1 is z_traj itself), and gtf_wgrad_kernel then forms dW = X^T Y over all
// (T-1) K B rows as tiled products, split over SPLITS row ranges whose
// partials the caller sums in a fixed order. Everything is deterministic.
//
// What bounds it on the H100: the forward does 6*D*H-class MACs per particle
// row per step (3 launches of the training step: ~51 GFLOP in all at
// T = 25, B = 100, K = 1, 25, 1), the backward about three times that
// (recompute, input-gradient and weight-gradient products). Against 67 TFLOP/s
// of f32 outside the tensor cores both are bound by operations, not by device
// memory (the backward's rows are 2.3 KB each: 0.55 GB written and read at
// K = 25, about 0.3 ms). This simple kernel runs well above that bound:
// each CTA re-reads all weights from L2 every step (forward 1.5 MB, backward
// 3 MB per step at D = H = 256) and feeds the FMA units from shared memory
// one float4 per four FMAs. Tensor cores (wgmma) and keeping weight tiles in
// shared memory across a cluster are work for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr float kEps = 1e-8f;    // variance floor (_EPS)
constexpr float kPrecFloor = 1e-6f;

enum { EP_STORE = 0, EP_RELU_COLS = 1, EP_ADD = 2, EP_MASK = 3 };

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float softplus_(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float rsqrt_(float x) { return 1.f / sqrtf(x); }
__device__ __forceinline__ float sign_(float x) {
  return (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
}
__device__ __forceinline__ float pow_m15_(float x) { return 1.f / (x * sqrtf(x)); }

// acc[r] += sum_{j < NW} X[r, k + j] * w[j] for r < R (NW % 4 == 0). The
// rows are the inner loop, so consecutive FMAs go to different
// accumulators; each accumulator still sums over k in ascending order.
template <int KMAX, int NW>
__device__ __forceinline__ void fma_rows(const float* X, int ldx, int k,
                                         const float* w, float* acc, int R) {
#pragma unroll
  for (int j = 0; j < NW; j += 4) {
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      if (r < R) {
        const float4 x = *reinterpret_cast<const float4*>(X + r * ldx + k + j);
        acc[r] = fmaf(x.x, w[j], acc[r]);
        acc[r] = fmaf(x.y, w[j + 1], acc[r]);
        acc[r] = fmaf(x.z, w[j + 2], acc[r]);
        acc[r] = fmaf(x.w, w[j + 3], acc[r]);
      }
    }
  }
}

// Y[r, n] = ep(bias[n] + sum_k X[r, k] * W[k, n]) for r < R, n < ncols.
// X in shared memory (row stride ldx, 16-byte aligned rows), W in global
// memory with row stride ldw. EP_RELU_COLS applies ReLU to columns below
// relu_cols; EP_ADD adds into Y; EP_MASK multiplies by (Y[r, n] > 0), the
// ReLU derivative of the activation stored in Y. kin % 4 == 0.
// The weights stream from L2, so their loads are issued one chunk of
// W_CHUNK rows ahead of the products that use them, to keep enough of
// them in flight to cover L2's latency (32 rows where few particle rows
// leave registers free, 16 otherwise).
template <int KMAX, int EP>
__device__ __forceinline__ void gemm_rows(const float* X, int ldx, int kin,
                                          const float* __restrict__ W, int ldw,
                                          const float* __restrict__ bias,
                                          float* Y, int ldy, int ncols, int R,
                                          int relu_cols) {
  constexpr int W_CHUNK = KMAX > 8 ? 16 : 32;
  for (int n = threadIdx.x; n < ncols; n += NT) {
    float acc[KMAX];
    const float b0 = bias ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int r = 0; r < KMAX; ++r) acc[r] = b0;
    const float* wp = W + n;
    int k = 0;
    if (kin >= W_CHUNK) {
      float w[W_CHUNK];
#pragma unroll
      for (int j = 0; j < W_CHUNK; ++j) w[j] = __ldg(wp + (size_t)j * ldw);
      for (; k + W_CHUNK <= kin; k += W_CHUNK) {
        float wn[W_CHUNK];
        const bool more = k + 2 * W_CHUNK <= kin;
#pragma unroll
        for (int j = 0; j < W_CHUNK; ++j)
          wn[j] = more ? __ldg(wp + (size_t)(k + W_CHUNK + j) * ldw) : 0.f;
        fma_rows<KMAX, W_CHUNK>(X, ldx, k, w, acc, R);
#pragma unroll
        for (int j = 0; j < W_CHUNK; ++j) w[j] = wn[j];
      }
    }
    for (; k < kin; k += 4) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = __ldg(wp + (size_t)(k + j) * ldw);
      fma_rows<KMAX, 4>(X, ldx, k, w, acc, R);
    }
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      if (r < R) {
        float* y = Y + r * ldy + n;
        float v = acc[r];
        if (EP == EP_RELU_COLS) {
          if (n < relu_cols) v = fmaxf(v, 0.f);
        } else if (EP == EP_ADD) {
          v += *y;
        } else if (EP == EP_MASK) {
          v = v * ((*y > 0.f) ? 1.f : 0.f);
        }
        *y = v;
      }
    }
  }
}

// Copy columns [0, w) of K rows of shared-memory matrix X (row stride ldx)
// to rows row0 + r * B of global matrix G (row stride ldg), at column c0.
__device__ __forceinline__ void store_rows(const float* X, int ldx, int w,
                                           int K, float* G, size_t row0,
                                           int B, int ldg, int c0) {
  for (int i = threadIdx.x; i < K * w; i += NT) {
    const int r = i / w, c = i - r * w;
    G[(row0 + (size_t)r * B) * ldg + c0 + c] = X[r * ldx + c];
  }
}

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

struct Gtf {
  const float *w1, *b1, *wg2, *bg2, *wn2, *bn2, *ws, *bs;  // (in, out)
  const float *w1t, *wg2t, *wn2t, *wst;                     // (out, in)
};

struct Dims {
  int T, M, B, K, D, H;
  float min_std;
};

// Recompute the transition on the K rows of Z into A = [relu(gate_1) |
// relu(nonlin_1) | z_lin] (width 2H+D), G = gate_2 pre-activation,
// N = z_nonlin and S = z_to_std pre-activation.
template <int KMAX>
__device__ __forceinline__ void gtf_forward(const Gtf& g, const Dims& s,
                                            const float* Z, float* A, float* G,
                                            float* N, float* S) {
  const int D = s.D, H = s.H, K = s.K, la = 2 * H + D;
  gemm_rows<KMAX, EP_RELU_COLS>(Z, D, D, g.w1, la, g.b1, A, la, la, K, 2 * H);
  __syncthreads();
  gemm_rows<KMAX, EP_STORE>(A, la, H, g.wg2, D, g.bg2, G, D, D, K, 0);
  gemm_rows<KMAX, EP_STORE>(A + H, la, H, g.wn2, D, g.bn2, N, D, D, K, 0);
  __syncthreads();
  gemm_rows<KMAX, EP_STORE>(N, D, D, g.ws, D, g.bs, S, D, D, K, 0);
  __syncthreads();
}

struct FwdArgs {
  const float *obs_mean, *obs_std, *obs_mask, *glb_mean, *glb_std, *eps;
  Gtf g;
  float *prior_mean, *prior_std, *infer_mean, *infer_std, *samples, *z_traj;
  Dims s;
};

template <int KMAX>
__global__ void __launch_bounds__(NT) bfvi_scan_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Dims& s = a.s;
  const int D = s.D, H = s.H, K = s.K, M = s.M, B = s.B;
  const int la = 2 * H + D;
  const int b = blockIdx.x;
  float* Z = smem;             // K x D   particles z_{t-1}
  float* A = Z + K * D;        // K x la
  float* G = A + K * la;       // K x D
  float* N = G + K * D;        // K x D
  float* S = N + K * D;        // K x D

  for (int t = 0; t < s.T; ++t) {
    if (t > 0) gtf_forward<KMAX>(a.g, s, Z, A, G, N, S);
    for (int d = threadIdx.x; d < D; d += NT) {
      const size_t bd = (size_t)b * D + d;
      const float gm = a.glb_mean[bd], gs = a.glb_std[bd];
      float pm = gm, ps = gs;
      if (t > 0) {
        // PoE(global prior, GTF(z_k)) per particle, then the moment-matched
        // mixture over the K particles.
        const float p1 = 1.f / (gs * gs + kEps);
        float s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int r = 0; r < K; ++r) {
          const float gate = sigmoid_(G[r * D + d]);
          const float qm = (1.f - gate) * A[r * la + 2 * H + d] + gate * N[r * D + d];
          const float qs = softplus_(S[r * D + d]) + s.min_std;
          const float p2 = 1.f / (qs * qs + kEps);
          const float den2 = p1 + p2;
          const float ppm = (gm * p1 + qm * p2) / den2;
          const float pps = rsqrt_(den2);
          s1 += ppm;
          s2 += pps * pps;
          s3 += ppm * ppm;
        }
        const float mu = s1 / (float)K;
        const float var = s2 / (float)K + s3 / (float)K - mu * mu;
        pm = mu;
        ps = sqrtf(fmaxf(var, 0.f));
      }
      // Masked, signed-precision PoE with the M observation experts.
      const float prec_p = 1.f / (ps * ps + kEps);
      float num = pm * prec_p, den = prec_p;
      add_obs_experts(a.obs_mean, a.obs_std, a.obs_mask, t, M, B, b, D, d,
                      num, den);
      const bool low = den < kPrecFloor;
      const float safe = low ? 1.f : den;
      const float im = low ? 0.f : num / safe;
      const float is = low ? 1e3f : rsqrt_(safe);
      const size_t tbd = ((size_t)t * B + b) * D + d;
      a.prior_mean[tbd] = pm;
      a.prior_std[tbd] = ps;
      a.infer_mean[tbd] = im;
      a.infer_std[tbd] = is;
      float zs = 0.f;
#pragma unroll 4
      for (int r = 0; r < K; ++r) {
        const size_t o = (((size_t)t * K + r) * B + b) * D + d;
        const float z = im + __ldg(a.eps + o) * is;
        Z[r * D + d] = z;
        a.z_traj[o] = z;
        zs += z;
      }
      a.samples[tbd] = zs / (float)K;
    }
    __syncthreads();
  }
}

struct BwdArgs {
  const float *obs_mean, *obs_std, *obs_mask, *glb_mean, *glb_std, *eps,
      *z_traj, *prior_mean, *prior_std;
  const float *g_pm, *g_ps, *g_im, *g_is, *g_smp;
  Gtf g;
  float *d_obs_mean, *d_obs_std, *d_glb_mean, *d_glb_std;
  // Rows ((t-1) K + k) B + b for t >= 1: xs = [h1 | hn | z_nonlin]
  // (2H + D wide), ys = [d_a1 | d_b1 | d_zlin | d_a2 | d_znonlin | d_sraw]
  // (2H + 4D wide), the two sides of the weight-gradient products.
  float *xs, *ys;
  Dims s;
};

template <int KMAX>
__global__ void __launch_bounds__(NT) bfvi_scan_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Dims& s = a.s;
  const int D = s.D, H = s.H, K = s.K, M = s.M, B = s.B;
  const int la = 2 * H + D;
  const int b = blockIdx.x;
  float* Z = smem;             // K x D   z_{t-1}
  float* A = Z + K * D;        // K x la  [h1 | hn | z_lin], later their cotangents
  float* G = A + K * la;       // K x D   gate_2 pre-activation, then d_a2
  float* N = G + K * D;        // K x D   z_nonlin
  float* S = N + K * D;        // K x D   z_to_std pre-activation, then d_sraw
  float* C = S + K * D;        // K x D   particle cotangent carried over time
  const int lx = 2 * H + D, ly = la + 3 * D;

  for (int i = threadIdx.x; i < K * D; i += NT) C[i] = 0.f;
  for (int d = threadIdx.x; d < D; d += NT) {
    a.d_glb_mean[(size_t)b * D + d] = 0.f;
    a.d_glb_std[(size_t)b * D + d] = 0.f;
  }
  __syncthreads();

  for (int t = s.T - 1; t >= 0; --t) {
    const size_t row0 = (size_t)(t - 1) * K * B + b;  // rows of step t
    if (t > 0) {
      for (int i = threadIdx.x; i < K * D; i += NT) {
        const int r = i / D, d = i - r * D;
        Z[i] = a.z_traj[(((size_t)(t - 1) * K + r) * B + b) * D + d];
      }
      __syncthreads();
      gtf_forward<KMAX>(a.g, s, Z, A, G, N, S);
      store_rows(A, la, 2 * H, K, a.xs, row0, B, lx, 0);
      store_rows(N, D, D, K, a.xs, row0, B, lx, 2 * H);
    }

    for (int d = threadIdx.x; d < D; d += NT) {
      const size_t bd = (size_t)b * D + d;
      const size_t tbd = ((size_t)t * B + b) * D + d;
      // Obs-PoE pieces, recomputed.
      const float prior_m = a.prior_mean[tbd], prior_s = a.prior_std[tbd];
      const float var_p = prior_s * prior_s + kEps;
      const float prec_p = 1.f / var_p;
      float num = prior_m * prec_p, den = prec_p;
      add_obs_experts(a.obs_mean, a.obs_std, a.obs_mask, t, M, B, b, D, d,
                      num, den);
      const bool low = den < kPrecFloor;
      const float safe = low ? 1.f : den;

      // Cotangents into z_t -> inference mean/std.
      const float gsm = a.g_smp[tbd] / (float)K;
      float gsum = 0.f, gesum = 0.f;
#pragma unroll 4
      for (int r = 0; r < K; ++r) {
        const float gz = C[r * D + d] + gsm;
        gsum += gz;
        gesum += gz * __ldg(a.eps + (((size_t)t * K + r) * B + b) * D + d);
      }
      const float gim = a.g_im[tbd] + gsum;
      const float gis = a.g_is[tbd] + gesum;

      // Obs-PoE VJP.
      const float d_num = low ? 0.f : gim / safe;
      const float d_den =
          low ? 0.f : (-gim * num / (safe * safe) - 0.5f * gis * pow_m15_(safe));
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
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
      const float d_prior_m = d_num * prec_p + a.g_pm[tbd];
      const float d_prec_pp = d_num * prior_m + d_den;
      const float d_prior_s = d_prec_pp * (-2.f * prior_s / (var_p * var_p)) + a.g_ps[tbd];

      if (t == 0) {  // the global prior was the prior at t = 0
        a.d_glb_mean[bd] += d_prior_m;
        a.d_glb_std[bd] += d_prior_s;
        continue;
      }

      // PoE2 + mixture, recomputed, then their VJP.
      const float gm = a.glb_mean[bd], gs = a.glb_std[bd];
      const float p1 = 1.f / (gs * gs + kEps);
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int r = 0; r < K; ++r) {
        const float gate = sigmoid_(G[r * D + d]);
        const float qm = (1.f - gate) * A[r * la + 2 * H + d] + gate * N[r * D + d];
        const float qs = softplus_(S[r * D + d]) + s.min_std;
        const float p2 = 1.f / (qs * qs + kEps);
        const float den2 = p1 + p2;
        const float ppm = (gm * p1 + qm * p2) / den2;
        const float pps = rsqrt_(den2);
        s1 += ppm;
        s2 += pps * pps;
        s3 += ppm * ppm;
      }
      const float mu = s1 / (float)K;
      const float var = s2 / (float)K + s3 / (float)K - mu * mu;
      const float ps_val = sqrtf(fmaxf(var, kEps));  // floored at _EPS, as on the TPU
      const float d_var = (var > 0.f) ? d_prior_s / (2.f * ps_val) : 0.f;
      float dglb_m = 0.f, d_p1 = 0.f;
      for (int r = 0; r < K; ++r) {
        const float a2 = G[r * D + d];
        const float gate = sigmoid_(a2);
        const float zl = A[r * la + 2 * H + d];
        const float zn = N[r * D + d];
        const float sraw = S[r * D + d];
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
        dglb_m += d_num2 * p1;
        d_p1 += d_num2 * gm + d_den2;
        // GTF output VJP (elementwise part).
        S[r * D + d] = d_qs * sigmoid_(sraw);                       // d_sraw
        G[r * D + d] = d_qm * (zn - zl) * gate * (1.f - gate);      // d_a2
        A[r * la + 2 * H + d] = d_qm * (1.f - gate);                // d_zlin
        C[r * D + d] = d_qm * gate;                                 // d_znon, partial
      }
      a.d_glb_mean[bd] += dglb_m;
      a.d_glb_std[bd] += d_p1 * (-2.f * gs / ((gs * gs + kEps) * (gs * gs + kEps)));
    }
    __syncthreads();
    if (t == 0) break;

    // GTF VJP through the products; the cotangents of the products' outputs
    // go to ys for the weight gradients.
    gemm_rows<KMAX, EP_ADD>(S, D, D, a.g.wst, D, nullptr, C, D, D, K, 0);
    __syncthreads();
    store_rows(G, D, D, K, a.ys, row0, B, ly, la);          // d_a2
    store_rows(C, D, D, K, a.ys, row0, B, ly, la + D);      // d_znonlin
    store_rows(S, D, D, K, a.ys, row0, B, ly, la + 2 * D);  // d_sraw
    gemm_rows<KMAX, EP_MASK>(G, D, D, a.g.wg2t, H, nullptr, A, la, H, K, 0);
    gemm_rows<KMAX, EP_MASK>(C, D, D, a.g.wn2t, H, nullptr, A + H, la, H, K, 0);
    __syncthreads();
    store_rows(A, la, la, K, a.ys, row0, B, ly, 0);         // d_a1|d_b1|d_zlin
    gemm_rows<KMAX, EP_STORE>(A, la, la, a.g.w1t, D, nullptr, C, D, D, K, 0);
    __syncthreads();
  }
}

// dW[i, j] = sum_r X[r, i] Y[r, j] (i < M1, j < N1) and db[j] = sum_r Y[r, j]
// over rows r of split blockIdx.z; split s writes dW + s * P, db + s * P.
struct WgradJob {
  const float* X;
  const float* Y;
  int ldx, ldy, M1, N1;
  float *dW, *db;
};

constexpr int WG_TILE = 64, WG_ROWS = 16;

__global__ void __launch_bounds__(NT) gtf_wgrad_kernel(WgradJob j, int R,
                                                       int rows_per_split,
                                                       long long P) {
  __shared__ __align__(16) float Xs[WG_ROWS][WG_TILE];
  __shared__ __align__(16) float Ys[WG_ROWS][WG_TILE];
  const int i0 = blockIdx.x * WG_TILE, j0 = blockIdx.y * WG_TILE;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  float bsum = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += WG_ROWS) {
#pragma unroll
    for (int q = 0; q < WG_ROWS * WG_TILE / NT; ++q) {
      const int idx = tid + q * NT, rr = idx / WG_TILE, c = idx % WG_TILE;
      const int r = r0 + rr;
      Xs[rr][c] = (r < r_end && i0 + c < j.M1)
                      ? j.X[(size_t)r * j.ldx + i0 + c] : 0.f;
      Ys[rr][c] = (r < r_end && j0 + c < j.N1)
                      ? j.Y[(size_t)r * j.ldy + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < WG_ROWS; ++rr) {
      const float4 x = *reinterpret_cast<const float4*>(&Xs[rr][ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&Ys[rr][tx * 4]);
      const float xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[ii][jj] = fmaf(xv[ii], yv[jj], acc[ii][jj]);
    }
    if (blockIdx.x == 0 && tid < WG_TILE) {
#pragma unroll
      for (int rr = 0; rr < WG_ROWS; ++rr) bsum += Ys[rr][tid];
    }
    __syncthreads();
  }
  float* dW = j.dW + (size_t)blockIdx.z * P;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty * 4 + ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = j0 + tx * 4 + jj;
      if (i < j.M1 && c < j.N1) dW[(size_t)i * j.N1 + c] = acc[ii][jj];
    }
  }
  if (blockIdx.x == 0 && tid < WG_TILE && j0 + tid < j.N1)
    j.db[(size_t)blockIdx.z * P + j0 + tid] = bsum;
}

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, int grid, cudaStream_t stream,
                   void* args_ptr) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {args_ptr};
  err = cudaLaunchKernel((const void*)kern, dim3(grid), dim3(NT), params,
                         smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Gtf make_gtf(const float* w1, const float* b1, const float* wg2,
             const float* bg2, const float* wn2, const float* bn2,
             const float* ws, const float* bs, const float* w1t,
             const float* wg2t, const float* wn2t, const float* wst) {
  Gtf g;
  g.w1 = w1; g.b1 = b1; g.wg2 = wg2; g.bg2 = bg2; g.wn2 = wn2; g.bn2 = bn2;
  g.ws = ws; g.bs = bs; g.w1t = w1t; g.wg2t = wg2t; g.wn2t = wn2t; g.wst = wst;
  return g;
}

}  // namespace

extern "C" {

// Largest particle count the kernels take (register-resident row sums).
int bfvi_scan_max_k() { return 32; }

int bfvi_scan_fwd(const float* obs_mean, const float* obs_std,
                  const float* obs_mask, const float* glb_mean,
                  const float* glb_std, const float* w1, const float* b1,
                  const float* wg2, const float* bg2, const float* wn2,
                  const float* bn2, const float* ws, const float* bs,
                  const float* eps, float* prior_mean, float* prior_std,
                  float* infer_mean, float* infer_std, float* samples,
                  float* z_traj, int T, int M, int B, int K, int D, int H,
                  float min_std, void* stream) {
  FwdArgs a;
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.g = make_gtf(w1, b1, wg2, bg2, wn2, bn2, ws, bs, nullptr, nullptr,
                 nullptr, nullptr);
  a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.infer_mean = infer_mean; a.infer_std = infer_std;
  a.samples = samples; a.z_traj = z_traj;
  a.s.T = T; a.s.M = M; a.s.B = B; a.s.K = K; a.s.D = D; a.s.H = H;
  a.s.min_std = min_std;
  const size_t smem = (size_t)K * (5 * D + 2 * H) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= 1) return (int)launch(bfvi_scan_fwd_kernel<1>, smem, B, st, &a);
  if (K <= 8) return (int)launch(bfvi_scan_fwd_kernel<8>, smem, B, st, &a);
  if (K <= 32) return (int)launch(bfvi_scan_fwd_kernel<32>, smem, B, st, &a);
  return (int)cudaErrorInvalidValue;
}

int bfvi_scan_bwd(const float* obs_mean, const float* obs_std,
                  const float* obs_mask, const float* glb_mean,
                  const float* glb_std, const float* w1, const float* b1,
                  const float* wg2, const float* bg2, const float* wn2,
                  const float* bn2, const float* ws, const float* bs,
                  const float* w1t, const float* wg2t, const float* wn2t,
                  const float* wst, const float* eps, const float* z_traj,
                  const float* prior_mean, const float* prior_std,
                  const float* g_pm, const float* g_ps, const float* g_im,
                  const float* g_is, const float* g_smp, float* d_obs_mean,
                  float* d_obs_std, float* d_glb_mean, float* d_glb_std,
                  float* xs, float* ys, int T, int M, int B, int K, int D,
                  int H, float min_std, void* stream) {
  BwdArgs a;
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.z_traj = z_traj; a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.g_pm = g_pm; a.g_ps = g_ps; a.g_im = g_im; a.g_is = g_is; a.g_smp = g_smp;
  a.g = make_gtf(w1, b1, wg2, bg2, wn2, bn2, ws, bs, w1t, wg2t, wn2t, wst);
  a.d_obs_mean = d_obs_mean; a.d_obs_std = d_obs_std;
  a.d_glb_mean = d_glb_mean; a.d_glb_std = d_glb_std;
  a.xs = xs; a.ys = ys;
  a.s.T = T; a.s.M = M; a.s.B = B; a.s.K = K; a.s.D = D; a.s.H = H;
  a.s.min_std = min_std;
  const size_t smem = (size_t)K * (6 * D + 2 * H) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (K <= 1) err = launch(bfvi_scan_bwd_kernel<1>, smem, B, st, &a);
  else if (K <= 8) err = launch(bfvi_scan_bwd_kernel<8>, smem, B, st, &a);
  else if (K <= 32) err = launch(bfvi_scan_bwd_kernel<32>, smem, B, st, &a);
  return (int)err;
}

// The GTF weight gradients from the R rows that bfvi_scan_bwd wrote (and
// z_traj, whose first R rows are the input side of dW1), into `splits`
// partials laid out as [dW1 (D x la) | db1 | dWg2 (H x D) | dbg2 |
// dWn2 (H x D) | dbn2 | dWs (D x D) | dbs] each.
int gtf_wgrad(const float* z_traj, const float* xs, const float* ys,
              float* partial, int splits, int R, int D, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int la = 2 * H + D, lx = 2 * H + D, ly = la + 3 * D;
  const long long P = (long long)D * la + la + 2LL * (H * D + D) + D * D + D;
  float* dW1 = partial;
  float* dWg2 = dW1 + (size_t)D * la + la;
  float* dWn2 = dWg2 + (size_t)H * D + D;
  float* dWs = dWn2 + (size_t)H * D + D;
  const WgradJob jobs[4] = {
      {z_traj, ys, D, ly, D, la, dW1, dW1 + (size_t)D * la},
      {xs, ys + la, lx, ly, H, D, dWg2, dWg2 + (size_t)H * D},
      {xs + H, ys + la + D, lx, ly, H, D, dWn2, dWn2 + (size_t)H * D},
      {xs + 2 * H, ys + la + 2 * D, lx, ly, D, D, dWs, dWs + (size_t)D * D}};
  const int rows_per_split = (R + splits - 1) / splits;
  for (const WgradJob& j : jobs) {
    const dim3 grid((j.M1 + WG_TILE - 1) / WG_TILE,
                    (j.N1 + WG_TILE - 1) / WG_TILE, splits);
    gtf_wgrad_kernel<<<grid, NT, 0, st>>>(j, R, rows_per_split, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
