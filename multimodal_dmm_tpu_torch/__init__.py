"""multimodal_dmm_tpu_torch: the PyTorch/CUDA port of multimodal_dmm_tpu.

The JAX package beside it is the reference; every module here mirrors
one there (``ops/``, ``models/``, ``training/``, ``apps/``) and is held
against it by ``tests/test_torch_*.py``. The JAX package's Pallas
kernels, the BFVI filtering scan and the PoE + sampling cell, run here as
hand-written CUDA kernels for Hopper (``csrc/bfvi_scan.cu``,
``csrc/poe_cell.cu``); every other op is plain PyTorch.

Entry points run on the GPU unless the caller asks for the CPU: their
``device`` argument defaults to ``"cuda"`` and :func:`resolve_device`
raises when CUDA is not available, rather than quietly running on the
CPU.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises if it names CUDA and no
    CUDA device is available (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU" % (str(device),))
    return dev
