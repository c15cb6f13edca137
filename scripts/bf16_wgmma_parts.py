"""Where the time of a bf16 scan launch on the wgmma route goes, on the
card.

Builds copies of csrc/f32_scan.cu into the git-ignored
multimodal_dmm_tpu_torch/_build/parts_bf16/, each with parts of the bf16
wgmma kernels (bfvi_scan_fwd_bf16_wgmma_kernel,
bfvi_scan_bwd_bf16_wgmma_kernel) left out: the elementwise phases
("no_elementwise"), the products' epilogues ("no_epilogue"), the wgmma
instructions ("no_mma"), the copies of A from L2 ("no_a"), and all of
these with the weights' copies as well ("bare": what is left is the
loops, the ring's and the warpgroups' synchronisation and the grid
barriers). Those copies' results are wrong by design: only their times are
read; "full" is the committed kernel, checked against the bf16 plain
version (relative Frobenius norm). Each runs at z = h = 768, K = 25 (100
columns), at D = H = 256, K = 100 (25 columns), and at the spirals
widths run as D = 16, H = 32 with K = 65 (9 columns), T = 25, M = 3, the
forward and the backward timed in turns (chip_smoke.time_ms) beside the
tiled bf16 kernels (the twin, named) and the float32 wgmma route. The
committed kernels carry no switch. Run from the repository root on a
machine with the card:

    python3 scripts/bf16_wgmma_parts.py
"""

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

# (text of csrc/f32_scan.cuh, its replacement) for each part.
ELEMENTWISE = [
    ("      fwd_elementwise<kWgChunk>(a, t, red);",
     "      if (!BF16) fwd_elementwise<kWgChunk>(a, t, red);"),
    ("      bwd_elementwise<BF16, BF16 ? kBBwdChunk : kWgChunk>(a, t, red);",
     "      if (!BF16) bwd_elementwise<false, kWgChunk>(a, t, red);"),
    ("  if (!PRODUCER) bwd_elementwise<BF16, BF16 ? kBBwdChunk : kWgChunk>"
     "(a, 0, red);",
     "  if (!PRODUCER && !BF16) bwd_elementwise<false, kWgChunk>(a, 0, red);"),
]
EPILOGUE = [("      if (v0) epi_pair<true>(ep, r0, n, acc[4 * j], acc[4 * j + 1]);"
             "\n      if (v1) epi_pair<true>(ep, r1, n, acc[4 * j + 2], "
             "acc[4 * j + 3]);",
             "      if (v0 && acc[4 * j] == -1234.5f)\n"
             "        epi_pair<true>(ep, r0, n, acc[4 * j], acc[4 * j + 1]);")]
MMA = [("    for (int i = 0; i < 4; ++i)\n"
        "      BMma<BN>::run(acc, desc(a_s + 32 * i), desc(b + 32 * i));",
        "    for (int i = 0; i < 4; ++i) fence_acc(acc);")]
A = [("    if (s + kBSlots < ns) fetch(s + kBSlots);", ""),
     ("    if (p < ns) fetch(p);", "")]
B = [("    mbar_expect(full, bytes);\n"
      "    bulk_copy(rg.base + st * kBStageBytes,\n"
      "              m.w + ((size_t)s * m.npad + n0) * kBSlab, bytes, full);",
      "    mbar_expect(full, 0);")]
VARIANTS = {"full": [], "no_elementwise": ELEMENTWISE,
            "no_epilogue": EPILOGUE, "no_mma": MMA, "no_a": A,
            "bare": ELEMENTWISE + EPILOGUE + MMA + A + B}
# (K, columns, D, H)
SHAPES = ((25, 100, 768, 768), (100, 25, 256, 256), (65, 9, 16, 32))
OUT = os.path.join(ROOT, "multimodal_dmm_tpu_torch", "_build", "parts_bf16")


def build():
    """Each variant's library, nvcc with the build's flags, all at once."""
    src_dir = os.path.dirname(_build._target("f32_scan")[0])
    procs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(src_dir):
            text = open(os.path.join(src_dir, f)).read()
            if f == "f32_scan.cuh":
                for old, new in edits:
                    assert old in text, (name, old)
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc()] + _build._flags("f32_scan")
            + ["-o", os.path.join(d, "lib.so"), os.path.join(d, "f32_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, out))
        libs[name] = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
    return libs


def main():
    if not torch.cuda.is_available():
        print("bf16_wgmma_parts: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    libs = build()
    committed = _build.load("f32_scan")
    print(chip_smoke.card_line())
    for k, cols, d, h in SHAPES:
        gtf = {n: {kk: v.to(dev) for kk, v in p.items()}
               for n, p in chip_smoke.scan_gtf(0, d, h).items()}
        x, eps, cots = chip_smoke.scan_inputs(3, k, dev, 5, chip_smoke.T_MAIN,
                                              cols, d)
        what = "K = %d, %d columns, D = %d, H = %d" % (k, cols, d, h)
        exp = scan.bfvi_scan_fwd_ref(*x, gtf, eps, 1e-3, bf16=True)
        res = tuple(x) + (gtf, eps, exp[5], exp[0], exp[1])
        runs = {}
        for name, lib in list(libs.items()) + [("tiled", committed),
                                               ("f32_wgmma", committed)]:
            b16 = name != "f32_wgmma"
            route = "tiled" if name == "tiled" else None

            def fwd(lib=lib, b16=b16, route=route):
                _build._loaded["f32_scan"] = lib
                return scan.bfvi_scan_fwd_cuda(*x, gtf, eps, 1e-3, b16,
                                               route=route)

            def bwd(lib=lib, b16=b16, route=route):
                _build._loaded["f32_scan"] = lib
                return scan.bfvi_scan_bwd_cuda(res, cots, 1e-3, b16,
                                               route=route)
            runs[name] = (fwd, bwd)
        got = runs["full"][0]()
        err = max(chip_smoke.rel_fro(g, e) for g, e in zip(got, exp))
        print("%s: the full kernel's forward within %.3g of the bf16 plain "
              "version (relative Frobenius norm)" % (what, err))
        times = {n: [0.0, 0.0] for n in runs}
        for n in list(runs) + list(runs)[::-1]:
            for i, fn in enumerate(runs[n]):
                times[n][i] += chip_smoke.time_ms(fn, 3) / 2
        for n, (f, b) in times.items():
            print("  %s %-15s forward %.3f ms, backward %.3f ms"
                  % (what, n, f, b))
        _build._loaded["f32_scan"] = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
