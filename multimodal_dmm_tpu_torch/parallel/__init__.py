"""Parallelism: the process mesh, data-parallel train steps and the
launcher of the ranks (counterpart of multimodal_dmm_tpu/parallel)."""

from .mesh import (ColumnNoise, Mesh, SyncStats, eval_columns,
                   gather_columns, launch, make_2d_train_step,
                   make_dp_train_step, make_mesh, make_mesh_2d, parse_mesh,
                   replicated, shard_batch, sum_over_data)
