// The BFVI scan kernels in float32 on the routes of f32_scan.cuh ("column"
// and "wgmma"), the bf16 scans' wgmma route (bf16_gtf), and their C entry
// points; ops/cuda/bfvi_scan.py chooses the route (f32_scan_plan,
// bf16_scan_plan). bfvi_scan.cuh supplies the shared helpers only: its own
// kernels, the route "tiled", are built by bfvi_scan.cu and (bf16)
// bfvi_scan_bf16.cu.

#define BFVI_SCAN_HELPERS_ONLY 1
#include "f32_scan.cuh"

namespace {

using f32scan::BMats;
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

// Walks one direction's matrices in table order as their image lays them
// out: each ceil(K / slab) slabs of N rows padded to `rows`, `slab` values
// a row; f(table index, offset of the matrix in values, its padded rows).
// Returns the image's values (each half's, for a 3xTF32 image).
template <class F>
long long walk_image(int D, int H, int backward, int slab, int rows, F f) {
  int nk[f32scan::kMats][2];
  mat_shapes(D, H, nk);
  const int first = backward ? f32scan::WS_T : f32scan::W1;
  const int last = backward ? f32scan::kMats : f32scan::WS_T;
  long long off = 0;
  for (int i = first; i < last; ++i) {
    const int npad = (nk[i][0] + rows - 1) / rows * rows;
    f(i, off, npad);
    off += (long long)((nk[i][1] + slab - 1) / slab) * npad * slab;
  }
  return off;
}

// Floats of one direction's 3xTF32 image (hi, then lo), as f32_pack lays
// it out: 32-deep slabs of rows padded to kImgRows.
long long image_floats(int D, int H, int backward) {
  return 2 * walk_image(D, H, backward, f32scan::kSlab, f32scan::kImgRows,
                        [](int, long long, int) {});
}

// The table entries of one direction's matrices in `img`.
void set_mats(Mats* m, int D, int H, int backward, const float* img) {
  const long long half = image_floats(D, H, backward) / 2;
  walk_image(D, H, backward, f32scan::kSlab, f32scan::kImgRows,
             [&](int i, long long off, int npad) {
               m->m[i].hi = img + off;
               m->m[i].lo = img + half + off;
               m->m[i].npad = npad;
             });
}

// Words of one direction's bf16 image, as bf16_wgmma_pack lays it out:
// 64-deep slabs of rows padded to kBImgRows.
long long bf16_image_words(int D, int H, int backward) {
  return walk_image(D, H, backward, f32scan::kBSlab, f32scan::kBImgRows,
                    [](int, long long, int) {});
}

// The table entries of one direction's matrices in the bf16 image `img`.
void set_bmats(BMats* m, int D, int H, int backward, const uint16_t* img) {
  walk_image(D, H, backward, f32scan::kBSlab, f32scan::kBImgRows,
             [&](int i, long long off, int npad) {
               m->m[i].w = img + off;
               m->m[i].npad = npad;
             });
}

// A cooperative launch of one CTA on each SM (the wgmma kernels' grid, on
// either engine's table M, with `smem` bytes of dynamic shared memory):
// fails if the card cannot hold one.
template <typename Args, typename M>
cudaError_t launch_wgmma(void (*kern)(Args, M), cudaStream_t st, Args* a,
                         M* m, int smem = f32scan::kWgSmem) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, f32scan::kWgThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* params[] = {a, m};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms),
                                    dim3(f32scan::kWgThreads), params, smem,
                                    st);
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

// The bf16 forward scan on the wgmma route (bf16_gtf): bfvi_scan_fwd's
// arguments, then `rows` (null, or the (T-1) K B rows [h1 | hn | z_nonlin]
// of its transition, in f32) and the forward's bf16 image.
int bfvi_scan_fwd_bf16_wgmma(FWD_PARAMS, float* rows, const uint16_t* img,
                             long long img_words) {
  if (D % 16 || H % 16 || img_words != bf16_image_words(D, H, 0))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = fwd_args(FWD_ARGS, rows);
  BMats m = {};
  set_bmats(&m, D, H, 0, img);
  return (int)launch_wgmma(f32scan::bfvi_scan_fwd_bf16_wgmma_kernel,
                           (cudaStream_t)stream, &a, &m, f32scan::kBWgSmem);
}

// The bf16 backward scan on the wgmma route: bfvi_scan_bwd's arguments,
// then the rows in bfloat16 that it writes for gtf_wgrad_bf16_kernel
// (xs_bf, ys_bf as xs and ys, zs_bf as z_traj's first (T-1) K B rows) and
// the bias gradients' f32 sums, nch partials of 2H + 4D (bias_part,
// zeroed), as bfvi_scan_bwd_tiled takes them; then the forward image (the
// recompute's) and the backward one.
int bfvi_scan_bwd_bf16_wgmma(BWD_PARAMS, uint16_t* xs_bf, uint16_t* ys_bf,
                             uint16_t* zs_bf, float* bias_part, int nch,
                             const uint16_t* img_fwd, long long fwd_words,
                             const uint16_t* img_bwd, long long bwd_words) {
  if (D % 16 || H % 16 || nch < 1 ||
      fwd_words != bf16_image_words(D, H, 0) ||
      bwd_words != bf16_image_words(D, H, 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = bwd_args(BWD_ARGS);
  a.xs_bf = xs_bf; a.ys_bf = ys_bf; a.zs_bf = zs_bf;
  a.bias_part = bias_part; a.nch = nch;
  BMats m = {};
  set_bmats(&m, D, H, 0, img_fwd);
  set_bmats(&m, D, H, 1, img_bwd);
  return (int)launch_wgmma(f32scan::bfvi_scan_bwd_bf16_wgmma_kernel,
                           (cudaStream_t)stream, &a, &m, f32scan::kBWgSmem);
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
