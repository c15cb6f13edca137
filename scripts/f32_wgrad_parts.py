"""Where the time of a float32 weight-gradient launch on the wgmma route
goes, on the card.

Builds copies of csrc/f32_wgrad.cu into the git-ignored
multimodal_dmm_tpu_torch/_build/parts/, each with one part of every stage
of gtf_wgrad_wgmma_kernel left out: the conversion of the B boxes into
TF32 images ("no_convert"), the A fragments' loads and split ("no_a": the
products run on zero fragments) or the products ("no_mma"); those copies'
results are wrong by design, only their times are read. "cvt_split" splits
with the cvt.rna.tf32.f32 instruction in place of the kernel's integer
rounding: its partials must equal the committed kernel's ("full") bit for
bit. Each runs at the Weizmann step's K = 25 and
K = 1 launches (60,000 and 2,400 rows, D = H = 256) and VidTIMIT's K = 25
launch (148,125 rows), on f32_wgrad_plan's units and splits, timed in turns
by device time (chip_smoke.time_device_ms; the launch alone, without the
partials' sum). The committed kernel carries no switch. Run from the
repository root on a machine with the card:

    python3 scripts/f32_wgrad_parts.py
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

# The lines of csrc/f32_wgrad.cuh's consume() that each part spans (from
# the first anchor up to the second, which is kept), and the macro that
# leaves it out.
PARTS = {
    "WG_SKIP_CONVERT": ("    convert<BN>(st + 4 * kBox, ib, t);\n",
                        "    if (i > 0) {  // stage i - 1's products"),
    "WG_SKIP_A": ("    // Step k: a[0] = A[g][8 k + 2 q]",
                  "    // The image is whole"),
    "WG_SKIP_MMA": ("#pragma unroll\n    for (int k = 0; k < 4; ++k) {\n"
                    "      Mma<BN>::run(acc, lo[k]", "    wg_commit();\n"),
}
# The TF32 rounding by the cvt instruction.
CVT = ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
       "#ifdef WG_CVT_SPLIT\n  uint32_t r;\n"
       "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
       "  return r;\n#else\n"
       "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n#endif\n")
# Without the A part the products run on zero fragments.
ZERO_A = ("#else\n    for (int k = 0; k < 4; ++k)\n"
          "      for (int e = 0; e < 4; ++e) hi[k][e] = lo[k][e] = 0u;\n")
VARIANTS = {"full": [], "cvt_split": ["WG_CVT_SPLIT"],
            "no_convert": ["WG_SKIP_CONVERT"], "no_a": ["WG_SKIP_A"],
            "no_mma": ["WG_SKIP_MMA"]}
SHAPES = ((256, 256, 24 * 25 * 100), (256, 256, 24 * 100),
          (256, 256, 79 * 25 * 75))


def patched_source():
    """csrc/f32_wgrad.cuh with each part between #ifndef MACRO and
    #endif."""
    src = (_build.CSRC_DIR / "f32_wgrad.cuh").read_text()
    for macro, (start, end) in PARTS.items():
        if src.count(start) != 1:
            raise RuntimeError("csrc/f32_wgrad.cuh has changed: no single "
                               "%r" % start)
        i = src.index(start)
        j = src.index(end, i + 1)
        alt = ZERO_A if macro == "WG_SKIP_A" else ""
        src = (src[:i] + "#ifndef %s\n" % macro + src[i:j] + alt
               + "#endif\n" + src[j:])
    if src.count(CVT[0]) != 1:
        raise RuntimeError("csrc/f32_wgrad.cuh has changed: no single "
                           "%r" % CVT[0])
    return src.replace(*CVT)


def build():
    """The variants' libraries, built side by side."""
    out = _build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    (out / "f32_wgrad.cuh").write_text(patched_source())
    (out / "f32_wgrad.cu").write_text(
        (_build.CSRC_DIR / "f32_wgrad.cu").read_text())
    procs = {}
    for name, macros in VARIANTS.items():
        lib = out / ("lib%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + ["-D%s" % m for m in macros]
            + ["-o", str(lib), str(out / "f32_wgrad.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print("  %s: %s" % (name, regs[0] if regs else ""), flush=True)
        handle = ctypes.CDLL(str(lib))
        handle.gtf_wgrad_wgmma.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
        handle.gtf_wgrad_wgmma.restype = ctypes.c_int
        libs[name] = handle
    return libs


def main():
    if not torch.cuda.is_available():
        print("f32_wgrad_parts: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    libs = build()
    dev = torch.device("cuda")
    for d, h, n_rows in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        z = torch.randn((n_rows, d), generator=gen, device=dev)
        xs = torch.randn((n_rows, 2 * h + d), generator=gen, device=dev)
        ys = torch.randn((n_rows, 2 * h + 4 * d), generator=gen, device=dev)
        plan = scan.f32_wgrad_plan(d, h, n_rows)
        part = torch.empty((plan["splits"], scan.partial_size(d, h)),
                           device=dev)

        def run(lib, out=part):
            rc = lib.gtf_wgrad_wgmma(
                z.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                n_rows, d, h, plan["units"], plan["splits"],
                scan._stream(xs))
            if rc:
                raise RuntimeError("launch failed: CUDA error %d" % rc)
        same = torch.empty_like(part)
        run(libs["full"])
        run(libs["cvt_split"], same)
        if not torch.equal(part, same):
            raise RuntimeError("the cvt split's partials differ from the "
                               "kernel's at %d rows" % n_rows)
        times = {}
        for name in list(libs) + list(libs)[::-1]:
            ms = chip_smoke.time_device_ms(lambda: run(libs[name]), 10)
            times[name] = times.get(name, 0.0) + ms / 2
        print("D = %d, H = %d, %d rows (%d units x %d splits; cvt_split's "
              "partials equal the kernel's bit for bit): %s" % (
            d, h, n_rows, plan["units"], plan["splits"],
            ", ".join("%s %.4f ms" % kv for kv in times.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
