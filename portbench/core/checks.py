"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference run on the same weights, data and noise.

Training: the first three steps of the run (the window's own call and
loader, in set-up). Compared are each step's loss, the first gradient as
the optimizer got it (worked out from Adam's first moment after one step)
and the parameters' change over the three steps, the last two leaf by
leaf as the gap between the program's norm and the reference's, over the
larger of the reference leaf's norm and the median leaf's. A leaf whose
loss gradient in the reference is under a thousandth of the median leaf's
(a bias in front of a BatchNorm) moves under Adam by round-off alone and
is left out of the change.

Evaluation: a sample, drawn from the seed, of the evaluations completed
in the window; the summary terms that the configuration's ``eval_checks``
names (number: summary key), as relative gaps. The label accuracies
(argmaxes) are not compared: the control moves them on some seeds and not
on others.

The reference runs at the precision that the configuration states (its
TF32 flags: float32 matmuls, TF32 convolutions for the apps). ``control``
runs it in the program's place at a lower precision: ``"tf32"`` (the
matmuls on TF32 tensor cores too, the step below float32 matmuls with TF32
off) or ``"bf16"`` (bfloat16 autocast).
"""

import contextlib
import math

import numpy as np
import torch

from ..reference.metrics import batch_metrics, summarize
from ..reference.model import Reference, param_specs
from ..reference.replay import EvalBatch, TrainBatches
from .weights import make_tree

ADAM_BETA1 = 0.9
# Leaves of the change whose reference loss gradient is under this share of
# the median leaf's are left out.
STILL_LEAF = 1e-3


def leaves(tree, path=()):
    """[(path, tensor)] in the program's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    return []


CONTROLS = ("tf32", "bf16")


@contextlib.contextmanager
def precision(cfg, device, control=None):
    """The configuration's stated precision (its ``precision`` section's
    TF32 flags for the matmuls and the convolutions), or the control's: TF32
    matmuls and convolutions, or bfloat16 autocast over the stated flags;
    the backends' flags restored on exit."""
    if control not in (None,) + CONTROLS:
        raise ValueError("no control precision %r" % (control,))
    stated = cfg["precision"]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = (control == "tf32"
                                             or stated["matmul_tf32"])
    torch.backends.cudnn.allow_tf32 = (control == "tf32"
                                       or stated["cudnn_tf32"])
    try:
        with torch.autocast(device_type=torch.device(device).type,
                            dtype=torch.bfloat16,
                            enabled=control == "bf16"):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def anneal(max_val, t, length):
    """The trainer's linear KLD schedule from 0."""
    return max_val if t >= length else max_val * t / length


def initial_weights(cfg, weight_seed, device):
    p_spec, s_spec = param_specs(cfg)
    return (make_tree(p_spec, weight_seed, device),
            make_tree(s_spec, weight_seed + 1, device))


def reference_train(cfg, items, weight_seed, seed, device, n_steps=3,
                    control=None):
    """The reference's first ``n_steps`` steps of epoch 1: {"losses",
    "grad1" (as Adam got it), "loss_grad1", "change", "p0" (the initial
    weights), "paths"} with leaves in the program's order."""
    tr = cfg["train"]
    params, state = initial_weights(cfg, weight_seed, device)
    p0 = [p.detach().clone() for _, p in leaves(params)]
    paths = ["/".join(map(str, path)) for path, _ in leaves(params)]
    lv = [p for _, p in leaves(params)]
    for p in lv:
        p.requires_grad_(True)
    opt = torch.optim.Adam(lv, lr=tr["lr"], weight_decay=tr["w_decay"])
    ref = Reference(cfg)
    names = [m["name"] for m in cfg["modalities"]]
    data = TrainBatches(items, names, tr["batch_size"], tr["burst_frac"],
                        device)
    n_batches = math.ceil(len(items) / tr["batch_size"])
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"losses": []}
    for b, (inputs, targets, mask, n_data) in enumerate(
            data.epoch(seed * 100003 + 1, n_steps)):
        kld_mult = anneal(tr["kld_mult"], b + n_batches,
                          tr["kld_anneal"] * n_batches)
        for p in lv:
            p.grad = None
        with precision(cfg, device, control):
            loss = ref.step_loss(params, state, inputs, targets, mask,
                                 kld_mult, gen)
        # The backward under the forward's matmul and convolution flags;
        # bfloat16's products follow the forward's saved tensors.
        with precision(cfg, device,
                       None if control == "bf16" else control):
            (loss / n_data).backward()
        grads = [p.grad for p in lv]
        if all(bool(torch.isfinite(g).all()) for g in grads):
            if b == 0:
                out["loss_grad1"] = [g.detach().clone() for g in grads]
            opt.step()
            if b == 0:
                out["grad1"] = [opt.state[p]["exp_avg"] / (1 - ADAM_BETA1)
                                for p in lv]
        out["losses"].append(float(loss.detach()))
    out["change"] = [p.detach() - q for p, q in zip(lv, p0)]
    out["p0"] = p0
    out["paths"] = paths
    return out


def _norms(ts):
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in ts])


def leaf_gap(prog, ref, keep=None):
    """The worst leaf's |norm(prog) - norm(ref)| / max(norm(ref), median
    leaf's norm(ref)) over the leaves ``keep`` (default all)."""
    pn, rn = _norms(prog), _norms(ref)
    keep = np.ones(len(rn), bool) if keep is None else keep
    scale = np.maximum(rn, np.median(rn[keep]))
    return float(np.max(np.abs(pn - rn)[keep] / scale[keep]))


def compare_train(prog, ref):
    """{number: value} of a training record against the reference's. A
    record without a first gradient (a step that did not apply) reads 1."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"])]
    out = {"loss_gap": max(losses) if len(losses) == len(ref["losses"])
           else float("inf")}
    if "grad1" not in prog or "grad1" not in ref:
        out["grad_gap"] = 1.0
    else:
        out["grad_gap"] = leaf_gap(prog["grad1"], ref["grad1"])
    g = _norms(ref["loss_grad1"])
    keep = g >= STILL_LEAF * np.median(g)
    out["change_gap"] = (leaf_gap(prog["change"], ref["change"], keep)
                         if "change" in prog else 1.0)
    return out


def reference_eval(cfg, items, weight_seed, seed, device, calls,
                   control=None):
    """{call index: summary} of the reference's evaluations ``calls``
    (indices among all the program's evaluation calls, from the first),
    replaying the generator's draws of every call before them."""
    ev = cfg["eval"]
    params, state = initial_weights(cfg, weight_seed, device)
    ref = Reference(cfg)
    names = [m["name"] for m in cfg["modalities"]]
    batch = EvalBatch(items, names, ev["batch_sz_eval"], device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    n_mods, z = len(names), cfg["z_dim"]
    t_max, b_dim = batch.mask.shape[:2]
    with torch.no_grad():
        for c in range(max(calls) + 1):
            if c not in calls:
                torch.rand((n_mods, t_max, b_dim), generator=gen,
                           device=device)
                torch.randn((t_max, ev["flt_particles"], b_dim, z),
                            generator=gen, device=device)
                continue
            with precision(cfg, device, control):
                inputs = batch.task(gen, ev["drop_frac"], ev["start_frac"],
                                    ev["stop_frac"])
                outs, recon = ref.eval_forward(params, state, inputs, gen)
                outs = [o.float() for o in outs]
                recon = {m: r.float() for m, r in recon.items()}
                mets = batch_metrics(cfg, outs, recon, batch.targets,
                                     batch.mask, batch.lengths)
            out[c] = summarize(mets, batch.n_real, batch.n_frames)
    return out


def compare_eval(cfg, prog, ref):
    """{number: value}: the worst over the sampled calls of the relative gap
    of each summary term that ``eval_checks`` names to the reference's (a
    non-finite answer reads infinite)."""
    terms = cfg["eval_checks"]
    out = {k: 0.0 for k in terms}
    for c, r in ref.items():
        for num, key in terms.items():
            p = float(prog[c][key])
            gap = (abs(p - r[key]) / max(abs(r[key]), 1e-12)
                   if math.isfinite(p) else float("inf"))
            out[num] = max(out[num], gap)
    return out


def leaf_detail(prog, ref):
    """For the first gradient and the change: the leaf of the largest gap,
    its gap and its reference loss gradient over the median leaf's, the
    median leaf's gap and the number of leaves left out."""
    out = {}
    g = _norms(ref["loss_grad1"])
    keep = g >= STILL_LEAF * np.median(g)
    for key, mask in (("grad1", None), ("change", keep)):
        if key not in prog:
            continue
        pn, rn = _norms(prog[key]), _norms(ref[key])
        mask = np.ones(len(rn), bool) if mask is None else mask
        gaps = np.abs(pn - rn) / np.maximum(rn, np.median(rn[mask]))
        gaps = np.where(mask, gaps, 0.0)
        worst = int(np.argmax(gaps))
        groups = {}
        for path, gap in zip(ref["paths"], gaps):
            top = path.split("/")[0]
            groups[top] = max(groups.get(top, 0.0), float(gap))
        out[key] = {"worst": ref["paths"][worst],
                    "worst_gap": float(gaps[worst]),
                    "worst_loss_grad_share": float(g[worst] / np.median(g)),
                    "median_gap": float(np.median(gaps[mask])),
                    "left_out": int((~mask).sum()),
                    "worst_by_group": groups}
    if "losses" in prog and len(prog["losses"]) == len(ref["losses"]):
        out["loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(
            prog["losses"], ref["losses"])]
    return out


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number within its limit
    (a number with no limit fails)."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
