// The BFVI scan kernels' bfloat16 variants (MultiDMM(bf16_gtf=True)):
// bfvi_scan_fwd_bf16_kernel and bfvi_scan_bwd_bf16_kernel (bf16_scan.cuh:
// clusters over column groups, wgmma) and gtf_wgrad_bf16_kernel
// (bfvi_scan.cuh), with the C entry points bfvi_scan_fwd, bfvi_scan_bwd and
// gtf_wgrad, in a library of their own that nvcc builds beside the float32
// one (bfvi_scan.cu).

#define BFVI_SCAN_BF16 1
#include "bfvi_scan.cuh"
#include "bf16_scan.cuh"
