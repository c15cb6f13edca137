"""The training step and its optimizer (counterpart of the optimizer chain
and jitted train step of multimodal_dmm_tpu/training/trainer.py).

The optimizer is the JAX package's chain: optional global-norm clipping,
then additive L2 weight decay, then Adam, with an update whose gradients
are not all finite skipped altogether (Adam's moments and step count are
left as they were). Clip + L2 + Adam is ``torch.optim.Adam(weight_decay=
...)`` after ``clip_grad_norm_``, which tests/test_optimizer_parity.py
holds equal to the optax chain.

The flag surface, loaders, evaluation and checkpoints of the JAX Trainer
are not ported yet.
"""

import torch

from .. import resolve_device
from ..tree import tree_leaves, tree_map


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
