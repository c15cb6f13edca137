// Fused product of experts + particle sampling for one filtering step, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of multimodal_dmm_tpu/ops/pallas/poe_cell.py:
//   poe_sample_cell_kernel  <- poe_sample_cell / _kernel
// and computes what it computes, in float32: a precision-space PoE of the
// positive-std prior with M masked, signed-std experts (variance floor 1e-8;
// a total precision below 1e-6 gives mean 0 and std 1e3), then
// z_k = mean + eps_k * std for K particles, then their mean.
//
// Layout: prior_mean/prior_std (B, D), obs_mean/obs_std (M, B, D),
// obs_mask (M, B), eps and z (K, B, D), infer_mean/infer_std/sample (B, D).
// Any B, D, M >= 0 and K >= 1: the TPU's tiling limits (D % 128, B padded to
// a multiple of 8) do not apply.
//
// Design. The (b, d) elements are independent, so a CTA owns 32 consecutive
// elements of the flattened (B, D) plane and splits the K particles over 8
// groups of 32 threads (threadIdx.y): each warp reads one 128-byte row of eps
// and writes one of z per particle, coalesced. Each thread computes the PoE
// of its element itself (M + 1 experts from L1/L2: cheaper than a barrier),
// writes its particles and keeps their partial sum; the 8 partial sums of an
// element are added in a fixed order through shared memory, so the sample is
// deterministic (no atomics). At B * D = 6,400 this gives 200 CTAs for the
// 132 SMs.
//
// What bounds it on the H100: device memory. At (M, K, B, D) =
// (3, 200, 25, 256) it reads eps (5.1 MB) and writes z (5.1 MB), about
// 10.5 MB with the rest, 3.1 us at 3.35 TB/s; it does a few operations per
// byte. At that size a launch costs about as much as the work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;         // elements of the (B, D) plane per CTA
constexpr int KG = 8;            // particle groups per CTA
constexpr float kEps = 1e-8f;    // variance floor (_EPS)
constexpr float kPrecFloor = 1e-6f;

__device__ __forceinline__ float sign_(float x) {
  return (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
}

__global__ void __launch_bounds__(COLS * KG) poe_sample_cell_kernel(
    const float* __restrict__ prior_mean, const float* __restrict__ prior_std,
    const float* __restrict__ obs_mean, const float* __restrict__ obs_std,
    const float* __restrict__ obs_mask, const float* __restrict__ eps,
    float* __restrict__ infer_mean, float* __restrict__ infer_std,
    float* __restrict__ z, float* __restrict__ sample, int M, int B, int K,
    int D) {
  __shared__ float part[KG][COLS];
  const size_t n = (size_t)B * D;
  const size_t i = (size_t)blockIdx.x * COLS + threadIdx.x;
  const int ky = threadIdx.y;
  float s = 0.f;
  if (i < n) {
    const int b = (int)(i / D);
    const float pm = __ldg(prior_mean + i), ps = __ldg(prior_std + i);
    const float prec_p = 1.f / (ps * ps + kEps);  // the prior's std is positive
    float num = pm * prec_p, den = prec_p;
    for (int m = 0; m < M; ++m) {
      const float mk = __ldg(obs_mask + (size_t)m * B + b);
      if (mk > 0.f) {
        const float os = __ldg(obs_std + m * n + i);
        const float om = __ldg(obs_mean + m * n + i);
        const float prec = sign_(os) / (os * os + kEps);
        num += om * prec;
        den += prec;
      }
    }
    const bool low = den < kPrecFloor;
    const float safe = low ? 1.f : den;
    const float im = low ? 0.f : num / safe;
    const float is = low ? 1e3f : 1.f / sqrtf(safe);
    if (ky == 0) {
      infer_mean[i] = im;
      infer_std[i] = is;
    }
#pragma unroll 4
    for (int k = ky; k < K; k += KG) {  // 4 loads of eps in flight
      const float zk = im + __ldg(eps + k * n + i) * is;
      z[k * n + i] = zk;
      s += zk;
    }
  }
  part[ky][threadIdx.x] = s;
  __syncthreads();
  if (ky == 0 && i < n) {
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) tot += part[j][threadIdx.x];
    sample[i] = tot / (float)K;
  }
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error code (0 when it was accepted).
int poe_sample_cell(const float* prior_mean, const float* prior_std,
                    const float* obs_mean, const float* obs_std,
                    const float* obs_mask, const float* eps,
                    float* infer_mean, float* infer_std, float* z,
                    float* sample, int M, int B, int K, int D, void* stream) {
  if (M < 0 || B < 1 || K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)B * D + COLS - 1) / COLS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  poe_sample_cell_kernel<<<(unsigned)blocks, dim3(COLS, KG), 0,
                           (cudaStream_t)stream>>>(
      prior_mean, prior_std, obs_mean, obs_std, obs_mask, eps, infer_mean,
      infer_std, z, sample, M, B, K, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
