// The BFVI scan kernels in float32 on the routes of f32_scan.cuh ("column"
// and "wgmma"), and their C entry points; ops/cuda/bfvi_scan.py chooses the
// route (f32_scan_plan). bfvi_scan.cuh supplies the shared helpers only:
// its own kernels, the route "tiled", are built by bfvi_scan.cu.

#define BFVI_SCAN_HELPERS_ONLY 1
#include "f32_scan.cuh"

namespace {

using f32scan::Mat;
using f32scan::Mats;

// The (N, K) of each matrix of f32scan's table at widths (D, H).
void mat_shapes(int D, int H, int (*nk)[2]) {
  const int la = 2 * H + D;
  const int shapes[f32scan::kMats][2] = {
      {la, D}, {D, H}, {D, H}, {D, D},          // w1, wg2, wn2, ws
      {D, D}, {H, D}, {H, D}, {D, H}, {D, H}, {D, D}};  // the transposes
  for (int i = 0; i < f32scan::kMats; ++i) {
    nk[i][0] = shapes[i][0];
    nk[i][1] = shapes[i][1];
  }
}

long long mat_floats(int n, int k) {
  const int npad = (n + f32scan::kImgRows - 1) / f32scan::kImgRows *
                   f32scan::kImgRows;
  return (long long)((k + f32scan::kSlab - 1) / f32scan::kSlab) * npad *
         f32scan::kSlab;
}

// Floats of one direction's image (hi, then lo), as f32_pack lays it out:
// each matrix ceil(K / 32) slabs of N rows padded to kImgRows.
long long image_floats(int D, int H, int backward) {
  int nk[f32scan::kMats][2];
  mat_shapes(D, H, nk);
  long long half = 0;
  const int first = backward ? f32scan::WS_T : f32scan::W1;
  const int last = backward ? f32scan::kMats : f32scan::WS_T;
  for (int i = first; i < last; ++i) half += mat_floats(nk[i][0], nk[i][1]);
  return 2 * half;
}

// The table entries of one direction's matrices in `img`.
void set_mats(Mats* m, int D, int H, int backward, const float* img) {
  int nk[f32scan::kMats][2];
  mat_shapes(D, H, nk);
  const long long half = image_floats(D, H, backward) / 2;
  const int first = backward ? f32scan::WS_T : f32scan::W1;
  const int last = backward ? f32scan::kMats : f32scan::WS_T;
  long long off = 0;
  for (int i = first; i < last; ++i) {
    m->m[i].hi = img + off;
    m->m[i].lo = img + half + off;
    m->m[i].npad = (nk[i][0] + f32scan::kImgRows - 1) / f32scan::kImgRows *
                   f32scan::kImgRows;
    off += mat_floats(nk[i][0], nk[i][1]);
  }
}

// A cooperative launch of one CTA on each SM (the wgmma kernels' grid):
// fails if the card cannot hold one.
template <typename Args>
cudaError_t launch_wgmma(void (*kern)(Args, Mats), cudaStream_t st, Args* a,
                         Mats* m) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f32scan::kWgSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, f32scan::kWgThreads, f32scan::kWgSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* params[] = {a, m};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms),
                                    dim3(f32scan::kWgThreads), params,
                                    f32scan::kWgSmem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Args>
cudaError_t launch_column(void (*kern)(Args, int), int bwd, int cols,
                          cudaStream_t st, const Args& a) {
  const int bytes = f32scan::col_smem_bytes(bwd, cols * a.s.K, a.s.D, a.s.H);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (cols < 1) return cudaErrorInvalidValue;
  kern<<<(a.s.B + cols - 1) / cols, f32scan::kColThreads, bytes, st>>>(a,
                                                                        cols);
  return cudaGetLastError();
}

FwdArgs fwd_args(const float* obs_mean, const float* obs_std,
                 const float* obs_mask, const float* glb_mean,
                 const float* glb_std, const float* w1, const float* b1,
                 const float* wg2, const float* bg2, const float* wn2,
                 const float* bn2, const float* ws, const float* bs,
                 const float* eps, float* prior_mean, float* prior_std,
                 float* infer_mean, float* infer_std, float* samples,
                 float* z_traj, float* work, unsigned* bar, int T, int M,
                 int B, int K, int D, int H, float min_std, float* rows) {
  FwdArgs a;
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.w = Weights{w1, b1, wg2, bg2, wn2, bn2, ws, bs};
  a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.infer_mean = infer_mean; a.infer_std = infer_std;
  a.samples = samples; a.z_traj = z_traj; a.work = work; a.bar = bar;
  a.rows = rows;
  a.s = Dims{T, M, B, K, D, H, min_std};
  return a;
}

BwdArgs bwd_args(const float* obs_mean, const float* obs_std,
                 const float* obs_mask, const float* glb_mean,
                 const float* glb_std, const float* w1, const float* b1,
                 const float* wg2, const float* bg2, const float* wn2,
                 const float* bn2, const float* ws, const float* bs,
                 const float* eps, const float* z_traj,
                 const float* prior_mean, const float* prior_std,
                 const float* g_pm, const float* g_ps, const float* g_im,
                 const float* g_is, const float* g_smp, float* d_obs_mean,
                 float* d_obs_std, float* d_glb_mean, float* d_glb_std,
                 float* xs, float* ys, float* gz, unsigned* bar, int T, int M,
                 int B, int K, int D, int H, float min_std) {
  BwdArgs a;
  a.obs_mean = obs_mean; a.obs_std = obs_std; a.obs_mask = obs_mask;
  a.glb_mean = glb_mean; a.glb_std = glb_std; a.eps = eps;
  a.z_traj = z_traj; a.prior_mean = prior_mean; a.prior_std = prior_std;
  a.g_pm = g_pm; a.g_ps = g_ps; a.g_im = g_im; a.g_is = g_is; a.g_smp = g_smp;
  a.w = Weights{w1, b1, wg2, bg2, wn2, bn2, ws, bs};
  a.d_obs_mean = d_obs_mean; a.d_obs_std = d_obs_std;
  a.d_glb_mean = d_glb_mean; a.d_glb_std = d_glb_std;
  a.xs = xs; a.ys = ys; a.gz = gz; a.bar = bar;
  a.s = Dims{T, M, B, K, D, H, min_std};
  a.xs_bf = a.ys_bf = a.zs_bf = nullptr;
  a.bias_part = nullptr;
  a.nch = 0;
  return a;
}

}  // namespace

#define FWD_PARAMS                                                          \
  const float *obs_mean, const float *obs_std, const float *obs_mask,      \
      const float *glb_mean, const float *glb_std, const float *w1,        \
      const float *b1, const float *wg2, const float *bg2,                 \
      const float *wn2, const float *bn2, const float *ws,                 \
      const float *bs, const float *eps, float *prior_mean,                \
      float *prior_std, float *infer_mean, float *infer_std,               \
      float *samples, float *z_traj, float *work, unsigned *bar, int T,    \
      int M, int B, int K, int D, int H, float min_std, void *stream
#define FWD_ARGS                                                            \
  obs_mean, obs_std, obs_mask, glb_mean, glb_std, w1, b1, wg2, bg2, wn2,   \
      bn2, ws, bs, eps, prior_mean, prior_std, infer_mean, infer_std,      \
      samples, z_traj, work, bar, T, M, B, K, D, H, min_std
#define BWD_PARAMS                                                          \
  const float *obs_mean, const float *obs_std, const float *obs_mask,      \
      const float *glb_mean, const float *glb_std, const float *w1,        \
      const float *b1, const float *wg2, const float *bg2,                 \
      const float *wn2, const float *bn2, const float *ws,                 \
      const float *bs, const float *eps, const float *z_traj,              \
      const float *prior_mean, const float *prior_std, const float *g_pm,  \
      const float *g_ps, const float *g_im, const float *g_is,             \
      const float *g_smp, float *d_obs_mean, float *d_obs_std,             \
      float *d_glb_mean, float *d_glb_std, float *xs, float *ys,           \
      float *gz, unsigned *bar, int T, int M, int B, int K, int D, int H,  \
      float min_std, void *stream
#define BWD_ARGS                                                            \
  obs_mean, obs_std, obs_mask, glb_mean, glb_std, w1, b1, wg2, bg2, wn2,   \
      bn2, ws, bs, eps, z_traj, prior_mean, prior_std, g_pm, g_ps, g_im,   \
      g_is, g_smp, d_obs_mean, d_obs_std, d_glb_mean, d_glb_std, xs, ys,   \
      gz, bar, T, M, B, K, D, H, min_std

extern "C" {

// The forward scan on the wgmma route: bfvi_scan_fwd's arguments (work and
// bar as there), then `rows` (null, or the (T-1) K B rows [h1 | hn |
// z_nonlin] that it writes for its transition) and the forward image.
int bfvi_scan_fwd_wgmma(FWD_PARAMS, float* rows, const float* img,
                        long long img_floats) {
  if (img_floats != image_floats(D, H, 0)) return (int)cudaErrorInvalidValue;
  FwdArgs a = fwd_args(FWD_ARGS, rows);
  Mats m = {};
  set_mats(&m, D, H, 0, img);
  return (int)launch_wgmma(f32scan::bfvi_scan_fwd_wgmma_kernel,
                           (cudaStream_t)stream, &a, &m);
}

// The backward scan on the wgmma route: bfvi_scan_bwd's arguments, then
// the forward image (the recompute's) and the backward one.
int bfvi_scan_bwd_wgmma(BWD_PARAMS, const float* img_fwd, long long fwd_floats,
                        const float* img_bwd, long long bwd_floats) {
  if (fwd_floats != image_floats(D, H, 0) ||
      bwd_floats != image_floats(D, H, 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = bwd_args(BWD_ARGS);
  Mats m = {};
  set_mats(&m, D, H, 0, img_fwd);
  set_mats(&m, D, H, 1, img_bwd);
  return (int)launch_wgmma(f32scan::bfvi_scan_bwd_wgmma_kernel,
                           (cudaStream_t)stream, &a, &m);
}

// The forward scan on the column route: `cols` batch columns a CTA; work
// and bar are not read.
int bfvi_scan_fwd_column(FWD_PARAMS, float* rows, int cols) {
  return (int)launch_column(f32scan::bfvi_scan_fwd_column_kernel, 0, cols,
                            (cudaStream_t)stream, fwd_args(FWD_ARGS, rows));
}

// The backward scan on the column route; gz and bar are not read.
int bfvi_scan_bwd_column(BWD_PARAMS, int cols) {
  return (int)launch_column(f32scan::bfvi_scan_bwd_column_kernel, 1, cols,
                            (cudaStream_t)stream, bwd_args(BWD_ARGS));
}

}  // extern "C"
