"""The training step, its optimizer, and evaluation (counterpart of the
optimizer chain, the jitted train step and ``evaluate`` of
multimodal_dmm_tpu/training/trainer.py).

The optimizer is the JAX package's chain: optional global-norm clipping,
then additive L2 weight decay, then Adam, with an update whose gradients
are not all finite skipped altogether (Adam's moments and step count are
left as they were). Clip + L2 + Adam is ``torch.optim.Adam(weight_decay=
...)`` after ``clip_grad_norm_``, which tests/test_optimizer_parity.py
holds equal to the optax chain.

``evaluate(loader, args)`` composes each eval task (random deletion,
kept segment, dropped and kept modalities), runs the model's forward
without gradients and reduces the app's metrics. With
``collect_results=False`` and an app that has ``compute_metrics_device``,
the eval set is uploaded once and everything per batch stays on the
device until one copy of the per-sequence metrics at the end
(``eval_engine.py``); otherwise the tasks are composed on the host with
numpy. ``args`` is any namespace with ``drop_frac``, ``start_frac``,
``stop_frac``, ``drop_mods``, ``keep_mods``, ``eval_mods``,
``rec_mults``, ``eval_args`` and ``visualize``.

The flag surface, training loop, checkpoints and visualization of the JAX
Trainer are not ported yet.
"""

import numpy as np
import torch

from .. import resolve_device
from ..data import multiseq as mseq
from ..tree import tree_leaves, tree_map
from .eval_engine import DeviceEvalData, compose_task


def method_eval_args(method, eval_args):
    """The eval args that ``--method`` sets (the JAX Trainer's
    ``pre_build_args``): ``bfvi`` filters with 200 particles unless
    ``eval_args`` says otherwise."""
    if method == "bfvi" and "flt_particles" not in eval_args:
        return dict(eval_args, flt_particles=200)
    if method not in (None, "bfvi"):
        raise NotImplementedError(
            "method %r (a DKS variant) is not ported yet; it comes with "
            "DKS in a later slice of the port" % (method,))
    return dict(eval_args)


class Trainer:
    """Holds a model's parameters, state, optimizer and sampling
    generator, and takes training steps.

    ``params``/``state`` default to ``model.init(seed)``; when given
    (for example from ``convert.params_from_jax``) they are moved to
    ``device``.
    """

    def __init__(self, model, lr, w_decay=1e-4, clip_grad=None,
                 skip_nonfinite=True, rec_mults=None, train_args=None,
                 seed=1, params=None, state=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        if params is None:
            params, state = model.init(seed, device=self.device)
        to_dev = lambda x: x.detach().to(self.device).clone()  # noqa: E731
        self.params = tree_map(to_dev, params)
        self.state = tree_map(to_dev, state)
        self.leaves = tree_leaves(self.params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.clip_grad = clip_grad
        self.skip_nonfinite = skip_nonfinite
        self.optimizer = torch.optim.Adam(self.leaves, lr=lr,
                                          weight_decay=w_decay)
        self.rec_mults = dict(rec_mults or {})
        self.train_args = dict(train_args or {})
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._eval_dev_cache = {}  # key -> (dataset, DeviceEvalData)

    def apply_gradients(self):
        """One optimizer update from the leaves' ``.grad``; returns False
        (and changes nothing) when a gradient is not finite."""
        grads = [p.grad for p in self.leaves]
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            if not bool(finite.all()):
                return False
        if self.clip_grad is not None and self.clip_grad > 0:
            torch.nn.utils.clip_grad_norm_(self.leaves, self.clip_grad)
        self.optimizer.step()
        return True

    def train_step(self, inputs, targets, mask, kld_mult, n_data):
        """loss / n_data -> gradients -> update. Returns (loss, applied):
        the summed (unnormalised) loss as a detached tensor, and whether
        the update was applied."""
        for p in self.leaves:
            p.grad = None
        loss, new_state = self.model.step(
            self.params, self.state, inputs, mask, kld_mult, self.rec_mults,
            self.gen, targets=targets, train=True, **self.train_args)
        (loss / n_data).backward()
        applied = self.apply_gradients()
        self.state = tree_map(lambda x: x.detach(), new_state)
        return loss.detach(), applied

    # -- evaluation -----------------------------------------------------------

    def _to_device(self, batch):
        return {m: torch.as_tensor(batch[m], device=self.device)
                for m in batch if m in self.model.modalities}

    @staticmethod
    def _eval_config(args):
        """(rec_mults zeroed outside ``eval_mods``, forward kwargs)."""
        rec_mults = dict(args.rec_mults)
        if args.eval_mods != "all":
            for m in rec_mults:
                rec_mults[m] *= float(m in args.eval_mods)
        return rec_mults, dict({"sample": False}, **args.eval_args)

    def evaluate(self, loader, args, collect_results=True):
        """Run the eval task over ``loader``. Returns (results, summary):
        per-sequence targets, inputs and reconstructions in input order
        when ``collect_results``, and ``summarize_metrics``' summary."""
        collect_results = collect_results or args.visualize
        if (not collect_results
                and getattr(self, "compute_metrics_device", None)
                is not None):
            return self._evaluate_device(loader, args)
        rec_mults, eval_args = self._eval_config(args)
        n_timesteps, metrics = 0, None
        results = {"seq_ids": [], "targets": [], "inputs": [], "recon": []}
        for targets, mask, lengths, order, ids in loader:
            inputs = mseq.rand_delete(targets, args.drop_frac, lengths)
            inputs = mseq.keep_segment(inputs, args.start_frac,
                                       args.stop_frac, lengths)
            for m in args.drop_mods:
                inputs[m][:] = float("nan")
            for m in args.keep_mods:
                inputs[m] = np.array(targets[m], copy=True)
            with torch.no_grad():
                (infer, prior, recon), _ = self.model.forward(
                    self.params, self.state, self._to_device(inputs),
                    gen=self.gen, **eval_args)
            n_timesteps += sum(lengths)
            b_metrics = self.compute_metrics(
                self.model, infer, prior, recon, targets, mask, lengths,
                order, args, rec_mults=rec_mults)
            metrics = (b_metrics if metrics is None else
                       {k: metrics[k] + b_metrics[k] for k in metrics})
            if collect_results:
                recon = {m: tuple(r.cpu().numpy() for r in rs)
                         for m, rs in recon.items()}
                results["seq_ids"] += [ids[i] for i in order]
                for k, v in (("targets", targets), ("inputs", inputs),
                             ("recon", recon)):
                    results[k].append(mseq.seq_decoll_dict(v, lengths,
                                                           order))
        if collect_results:
            for k in ("targets", "inputs", "recon"):
                results[k] = {m: [seq for batch in results[k]
                                  for seq in batch[m]]
                              for m in results[k][0]}
            if args.visualize:
                self.visualize(results, metrics[args.viz_metric], args)
        return results, self.summarize_metrics(metrics, n_timesteps)

    def _evaluate_device(self, loader, args):
        """The metrics-only evaluation on the device: the eval set is
        uploaded once per (dataset, batching); per batch the task, the
        forward and the per-sequence metrics run on the device; the
        metrics of all batches come to the host together at the end."""
        key = (id(loader.dataset), loader.batch_size,
               getattr(loader, "len_bucket", 0))
        cached = self._eval_dev_cache.get(key)
        if cached is None:
            data = DeviceEvalData(loader.dataset, self.model.modalities,
                                  loader.batch_size,
                                  len_bucket=getattr(loader, "len_bucket",
                                                     0),
                                  device=self.device)
            # Holding the dataset keeps its id() from being reused.
            self._eval_dev_cache[key] = (loader.dataset, data)
        else:
            data = cached[1]
        rec_mults, eval_args = self._eval_config(args)
        outs, n_timesteps = [], 0
        with torch.no_grad():
            for b in data.batches:
                inputs = compose_task(
                    b.targets, b.lengths_dev, self.gen, args.drop_frac,
                    args.start_frac, args.stop_frac, tuple(args.drop_mods),
                    tuple(args.keep_mods), modalities=self.model.modalities)
                (infer, prior, recon), _ = self.model.forward(
                    self.params, self.state, inputs, gen=self.gen,
                    **eval_args)
                outs.append(self.compute_metrics_device(
                    self.model, infer, prior, recon, b.targets, b.mask,
                    b.lengths_dev, rec_mults))
                n_timesteps += sum(b.lengths)
        outs = [{k: v.cpu().numpy() for k, v in out.items()} for out in outs]
        metrics = None
        for b, out in zip(data.batches, outs):
            # Per-sequence values back in input order, real sequences
            # only (ghost columns lie past them).
            b_metrics = {k: float(v) if v.ndim == 0 else
                         [v[i] for i in b.order] for k, v in out.items()}
            metrics = (b_metrics if metrics is None else
                       {k: metrics[k] + b_metrics[k] for k in metrics})
        return ({"seq_ids": [], "targets": [], "inputs": [], "recon": []},
                self.summarize_metrics(metrics, n_timesteps))

    # -- hooks of the apps ----------------------------------------------------

    def compute_metrics(self, model, infer, prior, recon, targets, mask,
                        lengths, order, args, rec_mults=None):
        raise NotImplementedError

    def summarize_metrics(self, metrics, n_timesteps):
        raise NotImplementedError

    def visualize(self, results, metric, args):
        raise NotImplementedError("visualize is not ported yet; it comes "
                                  "with the apps' CLI in a later slice of "
                                  "the port")
