"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, at first use, and loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds. Libraries go to
``multimodal_dmm_tpu_torch/_build/`` (git-ignored), named by a hash of
the source, every header in ``csrc/`` and the flags, so that an edited
source or header is rebuilt; ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>.log``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = {"bfvi_scan": "bfvi_scan.cu", "poe_cell": "poe_cell.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_loaded = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels in %s)" % CSRC_DIR)
    return path


def _target(name):
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / ("lib%s_%s.so" % (name, digest.hexdigest()[:16]))


def build(names=None):
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    wall seconds spent; raises with nvcc's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(".so.tmp%d" % os.getpid())
        log = open(BUILD_DIR / (name + ".log"), "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        msgs = [(BUILD_DIR / (n + ".log")).read_text() for n in failed]
        raise RuntimeError("nvcc failed for %s:\n%s"
                           % (", ".join(failed), "\n".join(msgs)))
    return time.perf_counter() - t0


def build_log(name):
    path = BUILD_DIR / (name + ".log")
    return path.read_text() if path.exists() else ""


def load(name):
    """The loaded ``ctypes`` library of kernel ``name``, built first if
    needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
    return _loaded[name]
