"""Where the time of a bf16 scan launch goes, phase by phase, on the card.

Builds a copy of csrc/bfvi_scan_bf16.cu whose csrc/bf16_scan.cuh reads
%globaltimer (CTA 0, thread 0) after every barrier, cluster barrier and
elementwise phase of the two scan kernels, into the git-ignored
multimodal_dmm_tpu_torch/_build/phases/; runs each kernel at the Weizmann
step's shapes (T = 25, 100 columns, D = H = 256, (M, K) = (3, 1) and
(3, 25)) through the port's wrappers; and prints, for each pair of
consecutive stamps, the source lines they follow and the mean time
between them over the launch's steps. The committed kernels carry no
timer. Run from the repository root on a machine with the card:

    python3 scripts/bf16_scan_phases.py
"""

import collections
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from multimodal_dmm_tpu_torch.ops.cuda import _build  # noqa: E402
from multimodal_dmm_tpu_torch.ops.cuda import bfvi_scan as scan  # noqa: E402

MARKS = ("publish();", "__syncthreads();", "cluster_sync();")
STARTS = ("fwd_elementwise(a", "bwd_elementwise(a", "publish();  //",
          "lane_sum(", "wg_wait0();")
STAMP = r'''
__device__ unsigned long long g_stamp[1 << 16];
__device__ int g_nstamp;
#define STAMP(id)                                                        \
  do {                                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0 && g_nstamp < (1 << 15)) {   \
      unsigned long long t_;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \
      g_stamp[2 * g_nstamp] = (id);                                      \
      g_stamp[2 * g_nstamp + 1] = t_;                                    \
      ++g_nstamp;                                                        \
    }                                                                    \
  } while (0)
'''
READ = r'''
extern "C" int stamps(unsigned long long* out) {
  int n = 0, z = 0;
  cudaMemcpyFromSymbol(&n, g_nstamp, sizeof(int));
  cudaMemcpyFromSymbol(out, g_stamp, sizeof(unsigned long long) * 2 * n);
  cudaMemcpyToSymbol(g_nstamp, &z, sizeof(int));
  return n;
}
'''


def timed_library():
    """Build the stamped copy; return (its ctypes library, source lines)."""
    src = (_build.CSRC_DIR / "bf16_scan.cuh").read_text().splitlines()
    out = []
    for i, line in enumerate(src, 1):
        out.append(line)
        s = line.strip()
        if s in MARKS or s.startswith(STARTS):
            out.append("STAMP(%d);" % i)
    text = "\n".join(out).replace("namespace {\nnamespace bf16scan {",
                                  STAMP + "namespace {\nnamespace bf16scan {",
                                  1) + READ
    work = _build.BUILD_DIR / "phases"
    work.mkdir(parents=True, exist_ok=True)
    (work / "bf16_scan_timed.cuh").write_text(text)
    cu = work / "bf16_scan_timed.cu"
    cu.write_text('#define BFVI_SCAN_BF16 1\n#include "bfvi_scan.cuh"\n'
                  '#include "bf16_scan_timed.cuh"\n#include "wgrad_bf16.cuh"\n')
    so = work / "libbf16_scan_timed.so"
    subprocess.run([_build._nvcc()] + _build._flags("bfvi_scan_bf16")
                   + ["-I", str(_build.CSRC_DIR), "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so)), src


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    lib, src = timed_library()
    real = scan._lib(True)
    for name in ("bfvi_scan_fwd", "bfvi_scan_bwd", "bfvi_scan_fwd_tiled",
                 "bfvi_scan_bwd_tiled", "gtf_wgrad_bf16",
                 "gtf_wgrad_bf16_partial_floats", "bfvi_scan_bf16_max_clusters"):
        getattr(lib, name).argtypes = getattr(real, name).argtypes
        getattr(lib, name).restype = getattr(real, name).restype
    lib._bfvi_typed = True
    plain_lib = scan._lib
    scan._lib = lambda bf16=False: lib if bf16 else plain_lib(False)
    buf = (ctypes.c_ulonglong * (1 << 16))()
    dev = torch.device("cuda")
    from multimodal_dmm_tpu_torch.apps import weizmann
    trainer = weizmann.make_trainer(seed=0, device=dev)
    gtf = {n: {k: v.detach() for k, v in p.items()}
           for n, p in trainer.params["trans"]["bwd"].items()}
    print(chip_smoke.card_line())

    def report(what):
        n = lib.stamps(buf)
        ids = [buf[2 * i] for i in range(n)]
        ts = [buf[2 * i + 1] for i in range(n)]
        gaps = collections.OrderedDict()
        for i in range(1, n):
            gaps.setdefault((ids[i - 1], ids[i]), []).append(ts[i] - ts[i - 1])
        print("%s: CTA 0, %.1f us from the first stamp to the last"
              % (what, (ts[-1] - ts[0]) / 1e3))
        for (a, b), v in gaps.items():
            print("  %7.2f us x %3d  after line %4d (%s) to line %4d (%s)"
                  % (sum(v) / len(v) / 1e3, len(v), a, src[a - 1].strip()[:30],
                     b, src[b - 1].strip()[:30]))

    for n_exp, k in ((3, 1), (3, 25)):
        x, eps, cots = chip_smoke.scan_inputs(n_exp, k, dev, 5)
        out = scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, True)
        res = tuple(x) + (gtf, eps, out[5], out[0], out[1])
        scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, True)  # warm-up
        torch.cuda.synchronize()
        for name, fn in (
                ("fwd", lambda: scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3,
                                                        True)),
                ("bwd", lambda: scan.bfvi_scan_bwd_cuda(res, cots, 1e-3,
                                                        True))):
            lib.stamps(buf)  # drops what earlier launches stamped
            fn()
            torch.cuda.synchronize()
            report("bfvi_scan_%s_bf16_kernel, (M, K) = (%d, %d)"
                   % (name, n_exp, k))
    return 0


if __name__ == "__main__":
    sys.exit(main())
