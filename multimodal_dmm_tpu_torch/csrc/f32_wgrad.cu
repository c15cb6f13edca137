// The float32 weight gradients' routes "narrow" and "wgmma" (f32_wgrad.cuh)
// and their C entry points gtf_wgrad_narrow and gtf_wgrad_wgmma;
// ops/cuda/bfvi_scan.py chooses the route (f32_wgrad_plan). The route
// "tiled", gtf_wgrad_kernel, is built by bfvi_scan.cu.

#include "f32_wgrad.cuh"
