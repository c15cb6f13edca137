// The BFVI scan kernels in float32 (3xTF32 products): bfvi_scan_fwd_kernel,
// bfvi_scan_bwd_kernel and gtf_wgrad_kernel, and their C entry points. The
// code is in bfvi_scan.cuh.

#include "bfvi_scan.cuh"
