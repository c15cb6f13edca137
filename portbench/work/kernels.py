"""Operations and bytes of the port's hand-written kernels, and the H100's
published peaks (NVIDIA's data sheet, SXM part, dense rates, 700 W).

After ``chip_smoke.py``'s ``scan_work``, ``cell_work``, ``step_work`` and
``bound_ms``: operations from the shapes, each input byte read once and
each output byte written once. The work is the algorithm's, whatever route
a launch takes, and only that of the real steps and columns: a padded slot
that a launch computes is no work that the batch requires.
"""

PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 tensor cores
PEAK_BF16_FLOPS = 989e12  # bfloat16 tensor cores
TF32_PASSES = 3           # a float32-accurate product takes 3 TF32 passes
PEAK_BYTES = 3.35e12      # HBM3
# The float32 products of the scans and weight gradients: three TF32
# passes each.
PEAK_F32_PRODUCTS = PEAK_TF32_FLOPS / TF32_PASSES


def scan_work(lengths, n_exp, k, d, h, launches=1):
    """((flops, bytes) of the forward scan, of the whole backward, of the
    weight-gradient products) over columns of the real ``lengths``, in
    ``launches`` launches: the six products of the transition at each real
    step t >= 1 of a column (the whole backward 3x the forward's: the
    recomputed forward, the input gradients, the weight gradients; the
    weight-gradient kernel does the last 1x), each input read once and
    each output written once, the weights once a launch. Elementwise work
    (under 2% of the products' operations) is left out."""
    gemm = 2 * (d * (2 * h + d) + 2 * h * d + d * d)
    n_cols, n_steps = len(lengths), sum(lengths)
    n_rows = (n_steps - n_cols) * k
    fwd_flops = n_rows * gemm
    n_w = (d * (2 * h + d) + 2 * h * d + d * d + 2 * h + 3 * d) * launches
    obs = 2 * n_steps * n_exp * d + n_steps * n_exp
    tbd, tkbd = n_steps * d, n_steps * k * d
    fwd_bytes = 4 * (obs + 2 * n_cols * d + n_w + tkbd + 5 * tbd + tkbd)
    bwd_bytes = 4 * (obs + 2 * n_cols * d + n_w + 2 * tkbd + 7 * tbd
                     + 2 * n_steps * n_exp * d + 2 * n_cols * d + n_w)
    wgrad_bytes = 4 * (n_rows * (d + (2 * h + d) + (2 * h + 4 * d)) + n_w)
    return ((fwd_flops, fwd_bytes), (3 * fwd_flops, bwd_bytes),
            (fwd_flops, wgrad_bytes))


def scan_kernels_work(lengths, n_exp, k, d, h, launches=1):
    """(flops, bytes) of the forward and backward scan kernels of one pass:
    the whole backward less the weight-gradient products, which other
    kernels compute."""
    (ff, fb), (bf, bb), (wf, _) = scan_work(lengths, n_exp, k, d, h,
                                            launches)
    return ff + (bf - wf), fb + bb


def cell_work(n_exp, k, b_dim, d):
    """(operations, bytes) of one cell launch over ``b_dim`` real columns:
    per (b, d) element the prior's and each expert's precision and product
    terms (about 8 + 5 M operations) and 3 per particle; each input read
    once and each output written once."""
    bd = b_dim * d
    flops = bd * (8 + 5 * n_exp + 3 * k)
    nbytes = 4 * (2 * bd + 2 * n_exp * bd + n_exp * b_dim + k * bd
                  + 3 * bd + k * bd)
    return flops, nbytes


def step_work(n_exp, k, b_dim, d):
    """(operations, bytes) of one filter-step launch over ``b_dim`` real
    columns: per particle element the transition's tail (about 12), the
    pair PoE with the global prior (12), the mixture's sums (5) and the
    sample (3); per (b, d) element the mixture's moments (8) and the cell's
    PoE (8 + 5 M). Bytes: the four product outputs and eps read, z written,
    (K, B, D) each; the prior and experts read, prior, infer and sample
    written."""
    bd, kbd = b_dim * d, k * b_dim * d
    flops = kbd * 32 + bd * (16 + 5 * n_exp)
    nbytes = 4 * (5 * kbd + kbd + 2 * bd + 2 * n_exp * bd + n_exp * b_dim
                  + 5 * bd)
    return flops, nbytes


def filter_pass_bound_ms(lengths, n_exp, k, d):
    """The least time of one sampled filtering pass over columns of the
    real ``lengths``: the cell launch over every column, then at each step
    t >= 1 a step launch over the columns still running, each launch at
    its own bound."""
    total = bound_ms(*cell_work(n_exp, k, len(lengths), d))
    for t in range(1, max(lengths)):
        active = sum(1 for n in lengths if n > t)
        total += bound_ms(*step_work(n_exp, k, active, d))
    return total


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """The least time of the work in ms: operations at ``peak`` or bytes at
    the HBM's rate, the larger."""
    return 1e3 * max(flops / peak, nbytes / PEAK_BYTES)
