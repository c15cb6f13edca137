"""What the ranks of tests/test_torch_parallel.py run, in a module that
imports neither JAX nor the JAX package, so that each spawned rank starts
with torch and the port alone. The models are built here from picklable
names, and every result goes back as numpy."""

import torch

from multimodal_dmm_tpu_torch.models import codecs, get_model
from multimodal_dmm_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                               parse_mesh, shard_batch)
from multimodal_dmm_tpu_torch.training.trainer import Trainer
from multimodal_dmm_tpu_torch.tree import tree_map

# A hung collective fails after this many seconds instead of eating the
# test run's time.
TIMEOUT = 120
ZH = 8          # latent and hidden widths of the narrow Weizmann model
MLP_MODS, MLP_DIMS = ["a", "b"], [2, 3]
WZ_MODS = ["video", "person", "action"]
WZ_DIMS = [(3, 8, 8), 10, 10]
WZ_DISTS = ["Bernoulli", "Categorical", "Categorical"]


def build(name):
    """The port's model ``name``: ``mlp`` (two Normal modalities, z = 4,
    h = 8, as tests/test_parallel.py), ``weizmann`` (the Weizmann
    modalities at narrow widths: 8x8 video through the conv codecs with
    BatchNorm, z = h = 8), or ``dks`` / ``vrnn`` on the mlp modalities."""
    if name == "mlp":
        return get_model("dmm")(MLP_MODS, MLP_DIMS, z_dim=4, h_dim=8)
    if name in ("dks", "vrnn"):
        return get_model(name)(MLP_MODS, MLP_DIMS, z_dim=4, h_dim=8)
    kw = dict(img_size=8, n_kernels=8)
    return get_model("dmm")(
        WZ_MODS, WZ_DIMS, dists=WZ_DISTS,
        encoders={"video": codecs.image_encoder_codec(ZH, **kw)},
        decoders={"video": codecs.image_decoder_codec(ZH, **kw)},
        z_dim=ZH, h_dim=ZH)


def to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def train_steps(name, params, state, batches, mesh, train_args, rec_mults,
                seed=0, lr=1e-3):
    """Steps of a ``Trainer`` of model ``name`` from (params, state) (CPU
    tensor trees), noise seeded with ``seed``, over ``batches`` of numpy
    (inputs, targets, mask, kld_mult), each the global batch: in this
    process with ``mesh`` "1", else as this rank of that mesh (in a
    process group of its size). Returns the losses, the gradients of the
    last step, and the parameters and state after it, as numpy."""
    trainer = Trainer(build(name), lr=lr, w_decay=1e-4, rec_mults=rec_mults,
                      train_args=train_args, seed=seed, params=params,
                      state=state, device="cpu")
    n_data, n_model = parse_mesh(mesh)
    if n_data * n_model > 1:
        trainer.set_mesh(make_mesh(n_data, "cpu") if n_model == 1 else
                         make_mesh_2d(n_data, n_model, "cpu",
                                      timeout=TIMEOUT))
    losses = []
    for inputs, targets, mask, kld_mult in batches:
        inputs, targets = ({m: torch.tensor(v) for m, v in d.items()}
                           for d in (inputs, targets))
        mask = torch.tensor(mask)
        n_data = float(mask.sum())
        if trainer.mesh is not None:
            inputs, _ = shard_batch(trainer.mesh, inputs, mask)
            targets, mask = shard_batch(trainer.mesh, targets, mask)
        loss, applied = trainer.train_step(inputs, targets, mask, kld_mult,
                                           n_data)
        assert applied
        losses.append(float(loss))
    grads = tree_map(lambda p: p.grad, trainer.params)
    return dict(losses=losses, grads=to_numpy(grads),
                params=to_numpy(trainer.params),
                state=to_numpy(trainer.state))


def run_jobs(jobs, mesh):
    """``train_steps(**job, mesh=mesh)`` for each named job of ``jobs``,
    in order (one process group serves them all)."""
    return {name: train_steps(mesh=mesh, **job) for name, job in jobs}
