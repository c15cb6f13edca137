// The BFVI scan kernels' bfloat16 variants (MultiDMM(bf16_gtf=True)):
// bfvi_scan_fwd_bf16_kernel, bfvi_scan_bwd_bf16_kernel and
// gtf_wgrad_bf16_kernel, with the same C entry points as bfvi_scan.cu, in a
// library of their own that nvcc builds beside it. The code is in
// bfvi_scan.cuh.

#define BFVI_SCAN_BF16 1
#include "bfvi_scan.cuh"
