// The BFVI scan kernels' bfloat16 variants (MultiDMM(bf16_gtf=True)), in a
// library of their own that nvcc builds beside the float32 one
// (bfvi_scan.cu):
//   - the cluster route, bfvi_scan_fwd_bf16_kernel and
//     bfvi_scan_bwd_bf16_kernel (bf16_scan.cuh: clusters over column
//     groups, wgmma), C entry points bfvi_scan_fwd and bfvi_scan_bwd;
//   - the tiled route, bfvi_scan_fwd_bf16_tiled_kernel and
//     bfvi_scan_bwd_bf16_tiled_kernel (bfvi_scan.cuh on the tile engine's
//     bf16 route), bfvi_scan_fwd_tiled and bfvi_scan_bwd_tiled, which run
//     where a caller names them: the twin of the wgmma route
//     (f32_scan.cuh, built by f32_scan.cu), which the plan gives the
//     widths and particle counts that no cluster holds;
//   - the weight gradients on both routes' bf16 rows, gtf_wgrad_bf16_kernel
//     (wgrad_bf16.cuh: TMA, wgmma), gtf_wgrad_bf16.

#define BFVI_SCAN_BF16 1
#include "bfvi_scan.cuh"
#include "bf16_scan.cuh"
#include "wgrad_bf16.cuh"
