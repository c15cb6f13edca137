"""Data parallelism over several GPUs: one process per rank and explicit
collectives (counterpart of multimodal_dmm_tpu/parallel/mesh.py).

The JAX package shards the batch axis of its jitted step over a device
mesh and lets GSPMD insert the collectives. Here each rank is a process
(``launch``) in a ``torch.distributed`` process group, and the step says
what GSPMD would do, so that it computes the single-device step:

- each rank takes a contiguous block of the (T, B, ...) batch's columns
  (``shard_batch``, the layout of ``batch_sharding`` on axis 1);
- it draws every noise tensor at the global batch's shape from the same
  seeded generator and keeps its own columns (``ColumnNoise``);
- BatchNorm normalises by the statistics of the global batch, summed over
  the ranks inside the autograd graph (``SyncStats``);
- it backpropagates ``local loss / n_data`` (``n_data`` the global count)
  and sums the gradients over the ranks in one ``all_reduce`` of a flat
  buffer, so the non-finite skip and Adam see the same gradients on every
  rank; the loss it reports is the summed loss of all ranks.

Only ``all_reduce`` and ``broadcast`` are used, the two collectives that
gloo also runs on CUDA tensors, so the same code runs under NCCL (one card
a rank) and under gloo (ranks on the CPU, or sharing one card).

A 2-D mesh (``make_mesh_2d``, ``--mesh NxM``) also splits the fused
objective's stacked variant rows over M model ranks
(``MultiDMM.set_variant_mesh``): rank (d, m) is ``d * M + m``.

Evaluation splits each batch's columns over the data axis where n_data
divides them (``eval_columns``, the rule of the JAX package's
``_eval_put``), else every rank computes the whole batch; its noise is
``ColumnNoise``'s, and ``gather_columns`` puts the ranks' blocks back
together on every rank.
"""

import datetime
import os
import pickle
import queue as queue_mod
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..tree import tree_leaves

# Seconds a collective may wait before it fails (the process group's
# timeout): long enough for rank 0's checkpoints and results export, while
# the other ranks wait.
DEFAULT_TIMEOUT = 1800


def parse_mesh(spec):
    """(n_data, n_model) of a ``--mesh`` value, ``"N"`` or ``"NxM"``;
    ``"0"`` and ``"1"`` are one device, (1, 1)."""
    spec = str(spec or 0).lower()
    n_data, n_model = ((int(v) for v in spec.split("x")) if "x" in spec
                       else (int(spec), 1))
    if n_data < 0 or n_model < 1:
        raise ValueError("--mesh %s: expected N or NxM with N, M >= 1"
                         % spec)
    return max(n_data, 1), n_model


class Mesh:
    """This rank's place in an (n_data x n_model) mesh of processes.

    ``group`` is the world; ``data_group`` the ranks with this rank's
    model index (they hold the n_data column blocks), ``model_group`` the
    ranks with its data index (they hold copies of the same columns and
    split the stacked variants; None on a 1-D mesh). ``device`` is this
    rank's device."""

    def __init__(self, n_data, n_model, device, data_group, model_group):
        self.group = dist.group.WORLD
        self.rank = dist.get_rank()
        self.n_data, self.n_model = n_data, n_model
        self.data_index, self.model_index = divmod(self.rank, n_model)
        self.device = device
        self.data_group, self.model_group = data_group, model_group

    def variant_rows(self, v_dim):
        """The rows of ``v_dim`` stacked variants that this rank's model
        index runs: contiguous shares, the first ones a row longer when M
        does not divide V (all of them on a 1-D mesh)."""
        rows = np.array_split(np.arange(v_dim), self.n_model)
        if not len(rows[-1]):
            raise ValueError(
                "a %dx%d mesh splits %d stacked variants over %d model "
                "ranks: some would get none" % (self.n_data, self.n_model,
                                                v_dim, self.n_model))
        return rows[self.model_index].tolist()


def _rank_device(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_world(n):
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh of %d ranks needs an initialized process group: start "
            "the ranks with parallel.launch (an app's main does)" % n)
    if dist.get_world_size() != n:
        raise ValueError("a mesh of %d ranks in a process group of %d"
                         % (n, dist.get_world_size()))


def make_mesh(n_data, device):
    """A 1-D mesh over the ``n_data`` ranks of the initialized process
    group, this rank on ``device``."""
    _check_world(n_data)
    return Mesh(n_data, 1, _rank_device(device), dist.group.WORLD, None)


def make_mesh_2d(n_data, n_model, device, timeout=None):
    """A 2-D (data x model) mesh over the ranks of the initialized process
    group, rank (d, m) = ``d * n_model + m``, with its data and model
    groups (``timeout``: theirs, in seconds; default the process group
    default)."""
    _check_world(n_data * n_model)
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    data_group, _ = dist.new_subgroups_by_enumeration(
        [grid[:, m].tolist() for m in range(n_model)], **kw)
    model_group, _ = dist.new_subgroups_by_enumeration(
        [grid[d].tolist() for d in range(n_data)], **kw)
    return Mesh(n_data, n_model, _rank_device(device), data_group,
                model_group)


def _in_place(tensors, device, collective):
    """Run ``collective`` on one flat buffer per dtype of ``tensors`` (on
    ``device``) and copy the result back into them."""
    by_dtype = {}
    for x in tensors:
        by_dtype.setdefault(x.dtype, []).append(x)
    with torch.no_grad():
        for xs in by_dtype.values():
            flat = torch.cat([x.reshape(-1).to(device) for x in xs])
            collective(flat)
            offset = 0
            for x in xs:
                x.copy_(flat[offset:offset + x.numel()].view(x.shape))
                offset += x.numel()


def replicated(mesh, tree):
    """Overwrite every tensor of ``tree`` (nested dicts and lists:
    parameters, BatchNorm state, Adam's state, a generator's state) with
    rank 0's value; returns ``tree``."""
    _in_place(tree_leaves(tree), mesh.device,
              lambda flat: dist.broadcast(flat, src=0, group=mesh.group))
    return tree


def all_reduce_grads(mesh, leaves):
    """Sum the ``.grad`` of ``leaves`` over the ranks, one ``all_reduce``
    per dtype (a leaf without a gradient contributes zeros)."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _in_place([p.grad for p in leaves], mesh.device,
              lambda flat: dist.all_reduce(flat, group=mesh.group))


def shard_batch(mesh, batch, mask):
    """This rank's columns of a dict of (T, B, ...) tensors and its (T, B,
    ...) mask: block ``data_index`` of ``n_data`` contiguous blocks on
    axis 1. Raises if ``n_data`` does not divide B."""
    b_dim = mask.shape[1]
    if b_dim % mesh.n_data:
        raise ValueError("a batch of %d columns over %d data ranks"
                         % (b_dim, mesh.n_data))
    n = b_dim // mesh.n_data
    cols = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    return ({m: v[:, cols].contiguous() for m, v in batch.items()},
            mask[:, cols].contiguous())


def eval_columns(mesh, b_dim):
    """The columns of a ``b_dim``-column evaluation batch that this rank
    computes: its block of ``n_data`` contiguous blocks where ``n_data``
    divides ``b_dim``, else None (every rank computes the whole batch), as
    the JAX package's ``_eval_put`` places an evaluation batch. The model
    ranks of one data index compute the same columns."""
    if mesh is None or b_dim % mesh.n_data or mesh.n_data == 1:
        return None
    n = b_dim // mesh.n_data
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def gather_columns(mesh, x, cols, b_dim, axis=1):
    """The whole batch of ``x``, which holds this rank's columns ``cols``
    (``eval_columns``) of ``b_dim`` on ``axis``, on every rank: each block
    placed in zeros and summed over the data axis's ranks (``all_reduce``,
    exact: every other term of a sum is 0)."""
    shape = list(x.shape)
    shape[axis] = b_dim
    full = x.new_zeros(shape)
    full.narrow(axis, cols.start, cols.stop - cols.start).copy_(x)
    dist.all_reduce(full, group=mesh.data_group)
    return full


def sum_over_data(mesh, x):
    """The sum of ``x`` over the data axis's ranks, on every rank."""
    x = x.clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the gradient of each rank's part is the sum of
    every rank's cotangent of the total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class SyncStats:
    """The ``train`` argument of a data-parallel step (true, like
    ``train=True``): ``models.nn.batchnorm_apply`` normalises by the
    statistics of the rows of every rank of ``group``, summed with
    ``all_reduce`` (differentiable)."""

    def __init__(self, group):
        self.group = group

    def all_reduce(self, x):
        return _AllReduceSum.apply(x, self.group)


class ColumnNoise:
    """A generator for a data-parallel step: each draw is made at the
    global batch's shape from ``gen`` (seeded alike on every rank) and cut
    to this rank's columns, so the ranks use the noise of the
    single-process step (``models.base.randn_cols``). ``v_dim``: the
    columns stack that many variants, V-major (``stacked``), of which this
    rank holds its ``variant_rows``."""

    def __init__(self, gen, mesh, b_local, v_dim=None):
        self.gen, self.mesh, self.b_local = gen, mesh, b_local
        self.v_dim = v_dim

    def stacked(self, v_dim):
        """The same generator for a batch of ``v_dim`` stacked variants."""
        return ColumnNoise(self.gen, self.mesh, self.b_local, v_dim)

    def randn(self, shape, device, dtype, axis=None):
        """``torch.randn(shape)`` for this rank; ``axis``: the axis of the
        rank's columns (None: the draw has none and is the same on every
        rank)."""
        if axis is None:
            return torch.randn(shape, generator=self.gen, device=device,
                               dtype=dtype)
        v_dim = self.v_dim
        rows = self.mesh.variant_rows(v_dim) if v_dim else [0]
        if shape[axis] != len(rows) * self.b_local:
            raise ValueError("noise of %d columns on axis %d for %d "
                             "variants of %d columns" % (
                                 shape[axis], axis, len(rows), self.b_local))
        n_global = self.b_local * self.mesh.n_data
        full = list(shape)
        full[axis] = (v_dim or 1) * n_global
        x = torch.randn(full, generator=self.gen, device=device, dtype=dtype)
        start = self.mesh.data_index * self.b_local
        idx = [v * n_global + start + j for v in rows
               for j in range(self.b_local)]
        return x.index_select(axis, torch.tensor(idx, device=device))


def make_dp_train_step(trainer, mesh):
    """The trainer's step as this rank's part of a data-parallel step:
    ``step(inputs, targets, mask, kld_mult, n_data)`` on this rank's
    columns (``shard_batch``), ``n_data`` the count of the global batch;
    returns (the summed loss of all ranks, whether the update was
    applied), as ``Trainer.train_step`` does for the whole batch."""
    stats = SyncStats(mesh.group)

    def reduce_grads():
        all_reduce_grads(mesh, trainer.leaves)

    def step(inputs, targets, mask, kld_mult, n_data):
        noise = ColumnNoise(trainer.gen, mesh, mask.shape[1])
        loss, applied = trainer.update(inputs, targets, mask, kld_mult,
                                       n_data, noise, train=stats,
                                       reduce_grads=reduce_grads)
        loss = loss.clone()
        dist.all_reduce(loss, group=mesh.group)
        return loss, applied
    return step


def make_2d_train_step(trainer, mesh):
    """``make_dp_train_step`` with the model's stacked variant rows split
    over the mesh's model axis (``set_variant_mesh``); raises
    ``ValueError`` for a model without them."""
    if not hasattr(trainer.model, "set_variant_mesh"):
        raise ValueError("model %s has no stacked-variant axis to shard; "
                         "use a 1-D mesh" % type(trainer.model).__name__)
    trainer.model.set_variant_mesh(mesh)
    return make_dp_train_step(trainer, mesh)


# -- the launcher --------------------------------------------------------------

def _rank_main(fn, args, rank, devices, backend, init, timeout, results):
    """One rank: its device, the process group, ``fn(*args)``; the result
    or the exception goes to ``results``, pickled here."""
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // len(devices)))
        # NCCL binds its communicator to the rank's card at once.
        bind = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init, world_size=len(devices), rank=rank,
            timeout=datetime.timedelta(seconds=timeout), **bind)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put(pickle.dumps((rank, True, out)))
    except Exception as e:
        tb = traceback.format_exc()
        try:
            msg = pickle.dumps((rank, False, (e, tb)))
        except Exception:  # noqa: BLE001 -- an exception that does not pickle
            msg = pickle.dumps((rank, False, (RuntimeError(repr(e)), tb)))
        results.put(msg)
        raise


def launch(fn, devices, backend, args=(), timeout=DEFAULT_TIMEOUT):
    """Run ``fn(*args)`` on ``len(devices)`` ranks, one process each
    (``torch.multiprocessing``, start method ``spawn``): rank r with
    ``devices[r]`` as its device (the current CUDA device, for a card), in
    one process group of ``backend`` (``"nccl"`` or ``"gloo"``) whose
    collectives fail after ``timeout`` seconds. The rendezvous is a file
    in a temporary directory. Rank 0 alone writes to standard output.
    Returns the ranks' results in rank order; if a rank raises, the others
    are terminated and its exception is raised here, with its traceback
    as a note. ``fn`` and ``args`` must pickle (``fn`` by import path)."""
    world = len(devices)
    ctx = mp.get_context("spawn")
    results_q = ctx.Queue()
    done, failure = {}, None
    with tempfile.TemporaryDirectory(prefix="mdmm_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, devices, backend, init,
                                   timeout, results_q))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            while len(done) < world and failure is None:
                try:
                    rank, ok, value = pickle.loads(results_q.get(timeout=0.5))
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        try:  # its message may still be in the pipe
                            rank, ok, value = pickle.loads(
                                results_q.get(timeout=5))
                        except queue_mod.Empty:
                            failure = dead[0][0], (RuntimeError(
                                "rank %d exited with code %s and no result"
                                % dead[0]), "")
                            continue
                    else:
                        continue
                if ok:
                    done[rank] = value
                else:
                    failure = rank, value
        finally:
            if len(done) < world:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
            for p in procs:
                p.join()
    if failure is not None:
        rank, (exc, tb) = failure
        exc.add_note("raised on rank %d of %d:\n%s" % (rank, world, tb))
        raise exc
    return [done[r] for r in range(world)]
