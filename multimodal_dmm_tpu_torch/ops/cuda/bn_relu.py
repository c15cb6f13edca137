"""Training-mode BatchNorm followed by ReLU on the codecs' convolutions:
four CUDA kernels for Hopper and the ``autograd.Function`` that joins them.

No TPU kernel is replaced: the JAX package leaves BatchNorm and ReLU to
XLA. The plain version is ``models.nn.batchnorm_apply`` followed by
``F.relu``, which ``models.nn.batchnorm_relu_apply`` runs on the CPU, in
evaluation and under a data-parallel ``SyncStats``; this module runs
single-rank training on CUDA float32.

- ``bn_relu_fwd_cuda`` launches ``bn_relu_stats_kernel`` (the batch mean and
  inverse std of every channel, and the running state moved by
  ``momentum`` towards them, into fresh tensors) and
  ``bn_relu_apply_kernel`` (y = relu((x - mean) gamma inv_std + beta)).
- ``bn_relu_bwd_cuda`` launches ``bn_relu_grad_sums_kernel`` (dgamma and
  dbeta, the ReLU's mask recomputed from x) and
  ``bn_relu_grad_apply_kernel`` (dx).
- ``bn_relu_train_cuda`` is the autograd entry: it saves x and the
  statistics (not y) and counts every kernel launch, forward and backward,
  in ``bn_relu_train_cuda.launches``: four a BatchNorm site of a step.

Layouts: x (N, C, spatial...) is taken as it is when it is dense with
channel-major planes (PyTorch's contiguous layout) or channels-last, the
two layouts the codecs' convolutions give; any other layout, and a
channels-last x of more than ``THREADS`` channels, is made contiguous
first. y and dx have x's strides; a dy of other strides is copied into
them. csrc/bn_relu.cu plans each launch from the shape, the layout and
the card's SM count (``bn_relu_plan`` reads that plan back).

Streams: the reductions' ticket counters and partials live in a workspace
kept for each stream (``_launch_args``), zeroed when it is made and left
zeroed by every launch that completes. Launches on one stream take it in
turn; launches on two streams, at once, each take their own. A kernel
that faults leaves the CUDA context unusable, so no later launch reads a
counter it left behind.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build

# csrc/bn_relu.cu: kThreads, the most channels a channels-last x takes.
THREADS = 256

# (device index, stream handle) -> the stream's workspace.
_WORKSPACES = {}
# device index -> its SM count.
_SMS = {}


def channels_last_layout(x):
    """False where x (N, C, ...) is contiguous, True where it is dense
    channels-last (C the fastest dimension, then the spatial ones in order,
    then N), None for any other layout."""
    if x.is_contiguous():
        return False
    order = [0] + list(range(2, x.dim())) + [1]
    stride = 1
    for d in reversed(order):
        if x.shape[d] != 1 and x.stride(d) != stride:
            return None
        stride *= x.shape[d]
    return True


def _layout(x):
    layout = channels_last_layout(x)
    if layout is None:
        raise ValueError("x must be contiguous or channels-last, got "
                         "strides %s" % (x.stride(),))
    return layout


def _same_strides(a, b):
    return all(size == 1 or sa == sb for size, sa, sb
               in zip(a.shape, a.stride(), b.stride()))


def _dims(x):
    n, c = x.shape[:2]
    s = 1
    for size in x.shape[2:]:
        s *= size
    return n, c, s


def _lib():
    lib = _build.load("bn_relu")
    if not getattr(lib, "_bn_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bn_relu_workspace_bytes.argtypes = [i]
        lib.bn_relu_workspace_bytes.restype = ctypes.c_longlong
        lib.bn_relu_plan.argtypes = [i] * 6 + [p]
        lib.bn_relu_stats.argtypes = [p] * 8 + [i] * 5 + [f] * 3 + [p]
        lib.bn_relu_apply.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.bn_relu_grad_sums.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.bn_relu_grad_apply.argtypes = [p] * 9 + [i] * 5 + [p]
        for fn in (lib.bn_relu_plan, lib.bn_relu_stats, lib.bn_relu_apply,
                   lib.bn_relu_grad_sums, lib.bn_relu_grad_apply):
            fn.restype = ctypes.c_int
        lib._bn_typed = True
    return lib


def bn_relu_plan(n, c, s, channels_last, sms, vec):
    """csrc/bn_relu.cu's launch plan for x of (N, C, S) elements (S the
    product of the spatial sizes) on a card of ``sms`` SMs, the apply
    kernels moving ``vec`` (4 or 1) floats a load: every channel's N S
    elements in ``chunks`` of ``chunk_len`` (elements of a channel, or
    rows of C for ``channels_last``), ``threads`` a reduction block,
    ``apply_blocks`` for the apply kernels and ``partials`` (chunks x C)
    in the workspace; ValueError for a shape or layout the kernels do not
    take."""
    out = (ctypes.c_longlong * 5)()
    rc = _lib().bn_relu_plan(n, c, s, int(channels_last), vec, sms, out)
    if rc != 0:
        raise ValueError("the BatchNorm kernels take no plan for N = %d, C = "
                         "%d, S = %d, channels-last %s, vec %d (CUDA error "
                         "%d)" % (n, c, s, channels_last, vec, rc))
    return dict(zip(("chunks", "chunk_len", "threads", "apply_blocks",
                     "partials"), out))


def workspace_bytes(sms):
    """The bytes of a stream's workspace on a card of ``sms`` SMs."""
    return _lib().bn_relu_workspace_bytes(sms)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _launch(name, *args):
    rc = getattr(_lib(), name)(*args)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, rc))
    bn_relu_train_cuda.launches += 1


def _check(name, x, shape=None):
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError("%s must be a float32 CUDA tensor, got %s on %s"
                         % (name, x.dtype, x.device))
    if shape is not None and (tuple(x.shape) != tuple(shape)
                              or not x.is_contiguous()):
        raise ValueError("%s must be contiguous of shape %s, got %s"
                         % (name, tuple(shape), tuple(x.shape)))


def _sms(device):
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def _launch_args(x):
    """(SM count, stream handle, the stream's workspace) for x's device
    and current stream; the workspace is made, zeroed, on first use."""
    sms = _sms(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (x.device.index, stream)
    work = _WORKSPACES.get(key)
    if work is None:
        work = _WORKSPACES[key] = torch.zeros(
            workspace_bytes(sms), dtype=torch.uint8, device=x.device)
    return sms, ctypes.c_void_p(stream), work


def bn_relu_fwd_cuda(x, gamma, beta, run_mean, run_var, eps, momentum):
    """Launch the statistics and apply kernels on the current stream.
    Returns (y, mean, inv_std, new_mean, new_var): y with x's strides, the
    batch statistics and the new running state (C,)."""
    n, c, s = _dims(x)
    _check("x", x)
    for name, t in (("gamma", gamma), ("beta", beta),
                    ("run_mean", run_mean), ("run_var", run_var)):
        _check(name, t, (c,))
    nsc = int(_layout(x))
    y = torch.empty_like(x)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    new_mean = torch.empty_like(run_mean)
    new_var = torch.empty_like(run_var)
    sms, stream, work = _launch_args(x)
    _launch("bn_relu_stats", _ptr(x), _ptr(run_mean), _ptr(run_var),
            _ptr(stats[0]), _ptr(stats[1]), _ptr(new_mean), _ptr(new_var),
            _ptr(work), n, c, s, nsc, sms, float(eps), float(momentum),
            float(1 - momentum), stream)
    _launch("bn_relu_apply", _ptr(x), _ptr(gamma), _ptr(beta),
            _ptr(stats[0]), _ptr(stats[1]), _ptr(y), n, c, s, nsc, sms,
            stream)
    return y, stats[0], stats[1], new_mean, new_var


def bn_relu_bwd_cuda(dy, x, gamma, beta, mean, inv_std):
    """Launch the backward's two kernels on the current stream. Returns
    (dx, dgamma, dbeta), dx with x's strides."""
    n, c, s = _dims(x)
    _check("x", x)
    _check("dy", dy)
    for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean),
                    ("inv_std", inv_std)):
        _check(name, t, (c,))
    nsc = int(_layout(x))
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError("dy has shape %s, x %s" % (tuple(dy.shape),
                                                    tuple(x.shape)))
    if not _same_strides(dy, x):
        dy = torch.empty_like(x).copy_(dy)
    dx = torch.empty_like(x)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
    sms, stream, work = _launch_args(x)
    _launch("bn_relu_grad_sums", _ptr(dy), _ptr(x), _ptr(gamma),
            _ptr(beta), _ptr(mean), _ptr(inv_std), _ptr(grads[0]),
            _ptr(grads[1]), _ptr(work), n, c, s, nsc, sms, stream)
    _launch("bn_relu_grad_apply", _ptr(dy), _ptr(x), _ptr(gamma),
            _ptr(beta), _ptr(mean), _ptr(inv_std), _ptr(grads[0]),
            _ptr(grads[1]), _ptr(dx), n, c, s, nsc, sms, stream)
    return dx, grads[0], grads[1]


class _BnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, run_mean, run_var, eps, momentum):
        y, mean, inv_std, new_mean, new_var = bn_relu_fwd_cuda(
            x, gamma, beta, run_mean, run_var, eps, momentum)
        ctx.save_for_backward(x, gamma, beta, mean, inv_std)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _d_mean, _d_var):
        dx, dgamma, dbeta = bn_relu_bwd_cuda(dy, *ctx.saved_tensors)
        return dx, dgamma, dbeta, None, None, None, None


def bn_relu_train_cuda(x, gamma, beta, run_mean, run_var, eps, momentum):
    """relu(BatchNorm(x)) by the batch statistics, on the kernels, with
    autograd. Returns (y, new_mean, new_var), the new running state
    detached. Raises for anything but float32 CUDA tensors."""
    layout = channels_last_layout(x)
    if layout is None or (layout and x.shape[1] > THREADS):
        x = x.contiguous()
    return _BnRelu.apply(x, gamma, beta, run_mean.contiguous(),
                         run_var.contiguous(), eps, momentum)


bn_relu_train_cuda.launches = 0
