"""The products that one training step and one evaluation of a
configuration require, counted from its shapes (2 operations a
multiply-add): the encoders' convolutions and heads, the decoders'
transposed convolutions and heads, every transition product of the
filtering and smoothing passes and of the prior-matching rollouts. A
backward counts twice its forward (input and weight gradients), once for
the first layer of an encoder, whose input needs no gradient; nothing is
counted for recomputation. Elementwise work, BatchNorm and the softmaxes
are left out. Only the real steps and columns count: a padded slot that the
program computes is no work that the batch requires.
"""


def _gtf_flops(d, h):
    """Operations of the gated transition on one particle row."""
    return 2 * (4 * d * h + 2 * d * d)


def _conv_shapes(mod):
    """[(c_in, c_out, kernel elements, output positions)] of the encoder's
    convolutions and [(c_in, c_out, kernel elements, input positions)] of
    the decoder's transposed ones."""
    n_layers, n_k = mod["n_layers"], mod["n_kernels"]
    c, size = mod["dims"][0], mod["dims"][1]
    enc_ch = [c] + [n_k // 2 ** (n_layers - 1 - l) for l in range(n_layers)]
    dec_ch = [n_k // 2 ** l for l in range(n_layers)] + [c]
    enc, dec = [], []
    if mod["codec"] == "image":
        pos = size
        for l in range(n_layers):
            pos //= 2
            enc.append((enc_ch[l], enc_ch[l + 1], 9, pos * pos))
        for l in range(n_layers):
            dec.append((dec_ch[l], dec_ch[l + 1], 16, pos * pos))
            pos *= 2
    else:
        pos = size
        for l in range(n_layers):
            pos = (pos - 1) // 2 + 1
            enc.append((enc_ch[l], enc_ch[l + 1], 3, pos))
        for l in range(n_layers):
            dec.append((dec_ch[l], dec_ch[l + 1], 3, pos))
            pos = 2 * pos - 1
    return enc, dec


def _feat_dim(mod):
    _, dec = _conv_shapes(mod)
    c_in, _, _, pos = dec[0]
    return c_in * pos


def encoder_flops(mod, z, h, rows, backward):
    """Forward operations of one modality's encoder on ``rows`` rows, and
    with ``backward`` its backward's too."""
    if mod["dist"] == "Categorical":
        fwd = 2 * rows * (h * h + 2 * h * z)
        return fwd * (3 if backward else 1)
    enc, _ = _conv_shapes(mod)
    convs = [2 * rows * ci * co * kk * pos for ci, co, kk, pos in enc]
    heads = 2 * 2 * rows * _feat_dim(mod) * z
    fwd = sum(convs) + heads
    if not backward:
        return fwd
    return fwd + 2 * fwd - convs[0]


def decoder_flops(mod, z, h, rows, backward):
    """Forward operations of one modality's decoder on ``rows`` rows, and
    with ``backward`` its backward's too."""
    if mod["dist"] == "Categorical":
        fwd = 2 * rows * (z * h + h * mod["dims"])
    else:
        _, dec = _conv_shapes(mod)
        fwd = 2 * rows * z * _feat_dim(mod) + sum(
            2 * rows * ci * co * kk * pos for ci, co, kk, pos in dec)
    return fwd * (3 if backward else 1)


def variants(cfg):
    """(number of loss variants, variants in which each modality is
    present): the joint one (with more than one modality) and one per
    modality."""
    n = len(cfg["modalities"])
    return (n + 1, 2) if n > 1 else (1, 1)


def scan_passes_train(cfg):
    """[(experts, variants, particles)] of a training step's filtering and
    smoothing passes: each pass runs every loss variant's copy of each
    column."""
    tr = cfg["train"]
    n = len(cfg["modalities"])
    v = variants(cfg)[0]
    passes = []
    for mode, k in ((tr["f_mode"], tr["flt_particles"]),
                    (tr["s_mode"], tr["train_particles"])):
        passes.append((n, v, k))
        if mode in ("fsmooth", "bsmooth"):
            passes.append((n + 2, v, 1))
    return passes


def train_flops(cfg, lengths, steps=1):
    """Operations that ``steps`` training steps require whose real columns
    (over all the steps) have the ``lengths``: a padded slot is no work."""
    z, h = cfg["z_dim"], cfg["h_dim"]
    rows = sum(lengths)
    trans_rows = rows - len(lengths)
    total = 0
    for mod in cfg["modalities"]:
        total += encoder_flops(mod, z, h, rows, True)
    gtf = _gtf_flops(z, h)
    total += steps * 3 * 2 * cfg["train"]["match_particles"] * gtf
    for _, v, k in scan_passes_train(cfg):
        total += 3 * trans_rows * v * k * gtf
    a_dim = variants(cfg)[1]
    for mod in cfg["modalities"]:
        total += 2 * decoder_flops(mod, z, h, rows * a_dim, True)
    return total


def eval_flops(cfg, lengths):
    """Operations that one evaluation of columns of the real ``lengths``
    requires: encoders, the sampled filtering pass, the smoothing pass,
    decoders (no metrics)."""
    z, h = cfg["z_dim"], cfg["h_dim"]
    rows = sum(lengths)
    trans_rows = rows - len(lengths)
    gtf = _gtf_flops(z, h)
    total = sum(encoder_flops(m, z, h, rows, False) + decoder_flops(
        m, z, h, rows, False) for m in cfg["modalities"])
    total += trans_rows * cfg["eval"]["flt_particles"] * gtf
    if cfg["eval"]["mode"] in ("fsmooth", "bsmooth"):
        total += trans_rows * gtf
    return total
