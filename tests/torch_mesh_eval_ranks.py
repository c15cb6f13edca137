"""What the ranks of tests/test_torch_mesh_eval.py run, in a module that
imports neither JAX nor the JAX package, so that each spawned rank starts
with torch and the port alone. Every result goes back as numpy or Python
numbers."""

import types

import numpy as np
import torch.distributed as dist

from multimodal_dmm_tpu_torch.apps import spirals, weizmann
from multimodal_dmm_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                               parse_mesh)
from multimodal_dmm_tpu_torch.training.loader import BatchLoader

# A hung collective fails after this many seconds instead of eating the
# test run's time.
TIMEOUT = 120
N_SEQS = 10     # spirals-shaped sequences of each evaluation
N_WZ = 4        # Weizmann sequences


def _record(trainer):
    """Keep each evaluation's per-sequence and summed metrics (the
    argument of ``summarize_metrics``) in ``trainer.recorded``."""
    trainer.recorded = []
    summarize = trainer.summarize_metrics

    def recording(metrics, n_timesteps):
        trainer.recorded.append({k: np.asarray(v, np.float64)
                                 for k, v in metrics.items()})
        return summarize(metrics, n_timesteps)
    trainer.summarize_metrics = recording
    return trainer


def spiral_items(seed=0):
    """``N_SEQS`` sequences of two 1-D Normal modalities, lengths 5-12."""
    rng = np.random.RandomState(seed)
    items = []
    for i in range(N_SEQS):
        length = int(rng.randint(5, 13))
        items.append({"spiral-x": rng.randn(length, 1).astype(np.float32),
                      "spiral-y": rng.randn(length, 1).astype(np.float32),
                      "length": length, "id": (i,)})
    return items


def weizmann_items(seed=0):
    """``N_WZ`` Weizmann sequences (64x64 video, person, action), lengths
    5-7."""
    rng = np.random.RandomState(seed + 1)
    items = []
    for i in range(N_WZ):
        length = int(rng.randint(5, 8))
        items.append({
            "video": rng.rand(length, 3, 64, 64).astype(np.float32),
            "person": np.full((length, 1), float(i % 10)),
            "action": rng.randint(0, 10, (length, 1)).astype(np.float64),
            "length": length, "id": ("shahar", i)})
    return items


def _namespace(eval_args, drop_frac, rec_mults):
    return types.SimpleNamespace(
        drop_frac=drop_frac, start_frac=0.25, stop_frac=0.9, drop_mods=[],
        keep_mods=[], eval_mods="all", visualize=False, rec_mults=rec_mults,
        eval_args=dict({"sample": False}, **eval_args))


def build(model):
    """A trainer of ``model`` on the CPU from seed 5: ``dmm``, ``dks`` or
    ``vrnn`` at the spirals app's widths, or ``weizmann`` (z = h = 8)."""
    if model == "weizmann":
        return weizmann.make_trainer(seed=5, device="cpu",
                                     model_args={"z_dim": 8, "h_dim": 8})
    return spirals.make_trainer(seed=5, device="cpu", model=model)


def evaluate(model, path, eval_args, batch_size, mesh):
    """One evaluation of ``build(model)``'s trainer, its generator and
    numpy seeded alike, in this process (``mesh`` "1") or as this rank of
    ``mesh``: ``path`` "device" (``_evaluate_device``) or "host" (the
    collect path). Returns the per-sequence and summed metrics, the
    summary, the generator's state after it and, on the host path, the
    reconstructions' means."""
    trainer = _record(build(model))
    n_data, n_model = parse_mesh(mesh)
    if n_data * n_model > 1:
        trainer.set_mesh(make_mesh(n_data, "cpu") if n_model == 1 else
                         make_mesh_2d(n_data, n_model, "cpu",
                                      timeout=TIMEOUT))
    items = weizmann_items() if model == "weizmann" else spiral_items()
    drop = 0.5 if path == "host" else 0.3
    args = _namespace(eval_args, drop, trainer.rec_mults)
    np.random.seed(7)
    trainer.gen.manual_seed(11)
    results, summary = trainer.evaluate(BatchLoader(items, batch_size), args,
                                        collect_results=path == "host")
    out = {"metrics": trainer.recorded[-1],
           "summary": {k: float(v) for k, v in summary.items()},
           "gen": trainer.gen.get_state().numpy()}
    if path == "host":
        out["recon"] = {m: [np.asarray(r[:, 0]) for r in rs]
                        for m, rs in results["recon"].items()}
    return out


def eval_jobs(jobs, mesh):
    """``evaluate(**job, mesh=mesh)`` for each named job of ``jobs``, in
    order (one process group serves them all)."""
    return {name: evaluate(mesh=mesh, **job) for name, job in jobs}


class FailingSpiralsTrainer(spirals.SpiralsTrainer):
    """A spirals trainer whose training run raises on rank 1 while rank 0
    goes on into the first step's collectives."""

    def run_train(self, args, reporter=None):
        if dist.is_initialized() and dist.get_rank() == 1:
            raise RuntimeError("rank 1 fails before its first step")
        return super().run_train(args, reporter)
