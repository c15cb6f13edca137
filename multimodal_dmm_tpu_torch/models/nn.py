"""Functional NN core (counterpart of multimodal_dmm_tpu/models/nn.py).

Parameters are plain dicts of tensors, in the same tree as the JAX
package's, but in PyTorch's layouts:

- linear ``w`` is (out, in), applied with ``F.linear``;
- conv2d ``w`` is OIHW; deconv2d ``w`` is ``ConvTranspose2d``'s
  (in, out, kH, kW);
- conv1d ``w`` is (out, in, k); deconv1d ``w`` is ``ConvTranspose1d``'s
  (in, out, k);
- activations are NCHW (NCW for the 1-D layers).

Initialisers draw from the JAX package's distributions (torch's defaults:
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), or xavier-uniform where the
reference asks for it) from an explicit ``torch.Generator``.
"""

import math

import torch
import torch.nn.functional as F


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32)
            * (2 * bound) - bound)


# ---------------------------------------------------------------------------
# Linear / MLP heads
# ---------------------------------------------------------------------------

def linear_init(gen, in_dim, out_dim, xavier=False):
    bound = (math.sqrt(6.0 / (in_dim + out_dim)) if xavier
             else 1.0 / math.sqrt(in_dim))
    return {"w": _uniform(gen, (out_dim, in_dim), bound),
            "b": _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))}


def linear_apply(p, x):
    return F.linear(x, p["w"], p["b"])


def embedding_init(gen, num, dim):
    """torch nn.Embedding default: N(0, 1)."""
    return {"w": torch.randn((num, dim), generator=gen)}


def embedding_apply(p, idx):
    return p["w"][idx]


def gaussian_mlp_init(gen, in_dim, out_dim, h_dim):
    """Linear + ReLU -> (mean, softplus std)."""
    return {"in_to_h": linear_init(gen, in_dim, h_dim),
            "h_to_mean": linear_init(gen, h_dim, out_dim),
            "h_to_std": linear_init(gen, h_dim, out_dim)}


def gaussian_mlp_apply(p, x, min_std=1e-3):
    h = F.relu(linear_apply(p["in_to_h"], x))
    mean = linear_apply(p["h_to_mean"], h)
    std = F.softplus(linear_apply(p["h_to_std"], h)) + min_std
    return mean, std


def categorical_mlp_init(gen, in_dim, out_dim, h_dim):
    """Linear + ReLU -> softmax probabilities."""
    return {"in_to_h": linear_init(gen, in_dim, h_dim),
            "h_to_out": linear_init(gen, h_dim, out_dim)}


def categorical_mlp_apply(p, x):
    h = F.relu(linear_apply(p["in_to_h"], x))
    return (torch.softmax(linear_apply(p["h_to_out"], h), dim=-1),)


# ---------------------------------------------------------------------------
# Gated transition function (GaussianGTF)
# ---------------------------------------------------------------------------

GTF_LAYERS = ("gate_1", "gate_2", "z_lin", "nonlin_1", "nonlin_2",
              "z_to_std")


def gtf_init(gen, z_dim, h_dim):
    shapes = {"gate_1": (z_dim, h_dim), "gate_2": (h_dim, z_dim),
              "z_lin": (z_dim, z_dim), "nonlin_1": (z_dim, h_dim),
              "nonlin_2": (h_dim, z_dim), "z_to_std": (z_dim, z_dim)}
    return {name: linear_init(gen, *shapes[name]) for name in GTF_LAYERS}


def gtf_apply(p, z, min_std=0.0):
    gate = torch.sigmoid(linear_apply(
        p["gate_2"], F.relu(linear_apply(p["gate_1"], z))))
    z_lin = linear_apply(p["z_lin"], z)
    z_nonlin = linear_apply(p["nonlin_2"],
                            F.relu(linear_apply(p["nonlin_1"], z)))
    z_std = F.softplus(linear_apply(p["z_to_std"], z_nonlin)) + min_std
    return (1 - gate) * z_lin + gate * z_nonlin, z_std


def gtf_pack(p, compute_dtype=None):
    """Concatenate the three z-side projections (gate_1, nonlin_1, z_lin)
    into one product and stack the two second-stage ones, so a time loop
    runs three products per step; ``gtf_apply_packed(gtf_pack(p), z)``
    equals ``gtf_apply(p, z)``. With ``compute_dtype`` (bfloat16) the
    three packed weights are cast to it once, here, as the JAX package's
    ``gtf_pack`` does, and ``"cd"`` names it; the biases stay float32.
    Where no gradient reaches the weights, the cast values are kept in
    float32 (exact there), so the products use them without a cast per
    call."""
    w1 = torch.cat([p["gate_1"]["w"], p["nonlin_1"]["w"], p["z_lin"]["w"]],
                   dim=0)
    w2 = torch.stack([p["gate_2"]["w"], p["nonlin_2"]["w"]])
    w3 = p["z_to_std"]["w"]
    if compute_dtype is not None:
        grad = torch.is_grad_enabled() and any(
            w.requires_grad for w in (w1, w2, w3))
        cast = ((lambda w: w.to(compute_dtype)) if grad
                else (lambda w: round_to(w, compute_dtype)))
        w1, w2, w3 = (cast(w) for w in (w1, w2, w3))
    return {
        "w1": w1,
        "b1": torch.cat([p["gate_1"]["b"], p["nonlin_1"]["b"],
                         p["z_lin"]["b"]]),
        "w2": w2,
        "b2": torch.stack([p["gate_2"]["b"], p["nonlin_2"]["b"]]),
        "w3": w3, "b3": p["z_to_std"]["b"],
        "h_dim": int(p["gate_1"]["w"].shape[0]),
        "cd": compute_dtype,
    }


def round_to(x, dtype):
    """``x`` rounded to ``dtype`` (to nearest even) and back to float32."""
    return x.to(dtype).to(torch.float32)


def linear_cd(x, w, b, cd=None):
    """``F.linear(x, w, b)``; with a compute dtype ``cd`` (bfloat16), whose
    values ``w`` holds (in that dtype or in float32), the JAX package's
    ``matmul(x.astype(cd), w).astype(float32) + b``: the input rounded to
    ``cd``, the product summed in float32 (a bfloat16 operand is exact
    there) and rounded to ``cd``, then the float32 bias. No bfloat16 GEMM
    runs: its accumulation would depend on the library. Autograd through
    it rounds each cotangent to ``cd`` before its transposed product and
    that product's output, as JAX's VJP does, and, for a ``w`` in ``cd``,
    sums w's gradient in ``cd``."""
    if cd is None:
        return F.linear(x, w, b)
    return round_to(F.linear(round_to(x, cd), w.to(torch.float32)),
                    cd) + b


def gtf_apply_packed(pk, z, min_std=0.0):
    h_dim, cd = pk["h_dim"], pk["cd"]
    a1 = linear_cd(z, pk["w1"], pk["b1"], cd)
    g1 = F.relu(a1[..., :h_dim])
    n1 = F.relu(a1[..., h_dim:2 * h_dim])
    z_lin = a1[..., 2 * h_dim:]
    gate = torch.sigmoid(linear_cd(g1, pk["w2"][0], pk["b2"][0], cd))
    z_nonlin = linear_cd(n1, pk["w2"][1], pk["b2"][1], cd)
    z_std = F.softplus(linear_cd(z_nonlin, pk["w3"], pk["b3"], cd)) + min_std
    return (1 - gate) * z_lin + gate * z_nonlin, z_std


# ---------------------------------------------------------------------------
# GRU (torch.nn.GRU's equations), for the DKS and VRNN recurrences
# ---------------------------------------------------------------------------

def gru_init(gen, in_dim, h_dim, n_layers=1, bias=True):
    """A stack of GRU layers, torch.nn.GRU's initialisation (U(-1/sqrt(H),
    1/sqrt(H))), in the JAX package's layout: ``w_ih`` (in, 3H), ``w_hh``
    (H, 3H), gates in the order r, z, n; zero biases without ``bias``."""
    bound = 1.0 / math.sqrt(h_dim)
    layers = []
    for layer in range(n_layers):
        d_in = in_dim if layer == 0 else h_dim
        p = {"w_ih": _uniform(gen, (d_in, 3 * h_dim), bound),
             "w_hh": _uniform(gen, (h_dim, 3 * h_dim), bound)}
        for name in ("b_ih", "b_hh"):
            p[name] = (_uniform(gen, (3 * h_dim,), bound) if bias
                       else torch.zeros((3 * h_dim,)))
        layers.append(p)
    return {"layers": layers}


def gru_cell(p_layer, x, h):
    """One step of one layer: x (..., in), h (..., H) -> h' (..., H)."""
    gi = x @ p_layer["w_ih"] + p_layer["b_ih"]
    gh = h @ p_layer["w_hh"] + p_layer["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def gru_step(p, x, h_stack):
    """One step through every layer; h_stack (n_layers, B, H) -> the new
    stack."""
    new_h = []
    inp = x
    for i, layer in enumerate(p["layers"]):
        inp = gru_cell(layer, inp, h_stack[i])
        new_h.append(inp)
    return torch.stack(new_h)


# ---------------------------------------------------------------------------
# Convolutions (NCHW, NCW)
# ---------------------------------------------------------------------------

def conv2d_init(gen, c_in, c_out, ksize=3, xavier=True):
    fan_in = c_in * ksize * ksize
    fan_out = c_out * ksize * ksize
    bound = (math.sqrt(6.0 / (fan_in + fan_out)) if xavier
             else 1.0 / math.sqrt(fan_in))
    return {"w": _uniform(gen, (c_out, c_in, ksize, ksize), bound),
            "b": _uniform(gen, (c_out,), 1.0 / math.sqrt(fan_in))}


def _biased(out, b):
    """A reduced-precision convolution's output in float32, plus the bias
    in float32 (the weights stay float32 masters)."""
    return out.to(torch.float32) + b.reshape((-1,) + (1,) * (out.dim() - 2))


def conv2d_apply(p, x, stride=2, padding=1, compute_dtype=None):
    """x: (N, C, H, W) -> (N, C', H', W'). With ``compute_dtype`` (for
    example bfloat16) the input and weights are cast to it and the
    convolution's output is rounded to it, as the JAX package does."""
    if compute_dtype is None:
        return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)
    return _biased(F.conv2d(x.to(compute_dtype), p["w"].to(compute_dtype),
                            stride=stride, padding=padding), p["b"])


def deconv2d_init(gen, c_in, c_out, ksize=4, xavier=True):
    """``ConvTranspose2d`` weight (in, out, kH, kW); xavier bounds use
    fan_in = in*k*k as torch computes them on that layout."""
    fan_in = c_in * ksize * ksize
    fan_out = c_out * ksize * ksize
    bound = (math.sqrt(6.0 / (fan_in + fan_out)) if xavier
             else 1.0 / math.sqrt(fan_out))
    return {"w": _uniform(gen, (c_in, c_out, ksize, ksize), bound),
            "b": _uniform(gen, (c_out,), 1.0 / math.sqrt(fan_out))}


def deconv2d_apply(p, x, stride=2, padding=1, compute_dtype=None):
    """out_size = (in - 1) * stride - 2 * padding + ksize;
    ``compute_dtype`` as in ``conv2d_apply``."""
    if compute_dtype is None:
        return F.conv_transpose2d(x, p["w"], p["b"], stride=stride,
                                  padding=padding)
    return _biased(F.conv_transpose2d(x.to(compute_dtype),
                                      p["w"].to(compute_dtype),
                                      stride=stride, padding=padding),
                   p["b"])


def conv1d_init(gen, c_in, c_out, ksize=3, xavier=True):
    fan_in = c_in * ksize
    fan_out = c_out * ksize
    bound = (math.sqrt(6.0 / (fan_in + fan_out)) if xavier
             else 1.0 / math.sqrt(fan_in))
    return {"w": _uniform(gen, (c_out, c_in, ksize), bound),
            "b": _uniform(gen, (c_out,), 1.0 / math.sqrt(fan_in))}


def conv1d_apply(p, x, stride=2, padding=1, compute_dtype=None):
    """x: (N, C, W) -> (N, C', W'); ``compute_dtype`` as in
    ``conv2d_apply``."""
    if compute_dtype is None:
        return F.conv1d(x, p["w"], p["b"], stride=stride, padding=padding)
    return _biased(F.conv1d(x.to(compute_dtype), p["w"].to(compute_dtype),
                            stride=stride, padding=padding), p["b"])


def deconv1d_init(gen, c_in, c_out, ksize=3, xavier=True):
    """``ConvTranspose1d`` weight (in, out, k)."""
    fan_in = c_in * ksize
    fan_out = c_out * ksize
    bound = (math.sqrt(6.0 / (fan_in + fan_out)) if xavier
             else 1.0 / math.sqrt(fan_out))
    return {"w": _uniform(gen, (c_in, c_out, ksize), bound),
            "b": _uniform(gen, (c_out,), 1.0 / math.sqrt(fan_out))}


def deconv1d_apply(p, x, stride=2, padding=1, compute_dtype=None):
    """out = (in - 1) * stride - 2 * padding + ksize; ``compute_dtype``
    as in ``conv2d_apply``."""
    if compute_dtype is None:
        return F.conv_transpose1d(x, p["w"], p["b"], stride=stride,
                                  padding=padding)
    return _biased(F.conv_transpose1d(x.to(compute_dtype),
                                      p["w"].to(compute_dtype),
                                      stride=stride, padding=padding),
                   p["b"])


# ---------------------------------------------------------------------------
# BatchNorm with explicit running state
# ---------------------------------------------------------------------------

def batchnorm_init(c, eps=1e-5, momentum=0.1):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c),
             "eps": eps, "momentum": momentum})


def _global_batchnorm(p, x, axes, eps, reduce):
    """Training-mode BatchNorm over the rows of every rank: the sums, the
    row count and then the squared deviations summed with ``reduce``,
    inside the graph. Returns (out, mean, biased var, n), the last three
    detached."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    n_local = x.numel() // x.shape[1]
    sums = reduce(torch.cat([x.sum(axes), x.new_full((1,), n_local)]))
    n = sums[-1].detach()
    mean = sums[:-1] / n
    xc = x - mean.reshape(shape)
    var = reduce((xc * xc).sum(axes)) / n
    out = (xc * torch.rsqrt(var + eps).reshape(shape)
           * p["scale"].reshape(shape) + p["bias"].reshape(shape))
    return out, mean.detach(), var.detach(), n


def batchnorm_apply(p, state, x, train):
    """x: (N, C, ...). In training, normalise by the batch statistics and
    return the running state moved by ``momentum`` towards them (unbiased
    variance); in evaluation, normalise by the running state. Returns
    (out, new_state); the input state is not modified. ``train`` may also
    be an object with a differentiable ``all_reduce(tensor)``, the sum over
    the ranks of a data-parallel step (``parallel.SyncStats``): the
    statistics, and the ``n`` of the unbiased variance, are then those of
    the rows of every rank."""
    if train:
        axes = [0] + list(range(2, x.dim()))
        reduce = getattr(train, "all_reduce", None)
        if reduce is None:
            out = F.batch_norm(x, None, None, p["scale"], p["bias"],
                               training=True, eps=state["eps"])
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=axes, correction=0)
                n = x.numel() // x.shape[1]
                unbiased = var * n / max(n - 1, 1)
        else:
            out, mean, var, n = _global_batchnorm(p, x, axes, state["eps"],
                                                  reduce)
            unbiased = var * n / torch.clamp(n - 1, min=1)
        with torch.no_grad():
            mom = state["momentum"]
            new_state = dict(state)
            new_state["mean"] = (1 - mom) * state["mean"] + mom * mean
            new_state["var"] = (1 - mom) * state["var"] + mom * unbiased
        return out, new_state
    out = F.batch_norm(x, state["mean"], state["var"], p["scale"],
                       p["bias"], training=False, eps=state["eps"])
    return out, state
