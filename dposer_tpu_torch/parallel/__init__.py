"""Several devices (port of ``dposer_tpu/parallel``): serving over a mesh,
multi-process evaluation and data-parallel training; see ``sharding.py``."""
from .sharding import (Mesh, allgather_ragged_1d, data_parallel_multi_step,
                       data_parallel_multi_step_indexed, data_parallel_sampler,
                       data_parallel_sampler_params, data_parallel_step, fold_seed,
                       init_distributed, join_rows, make_mesh, mesh_route,
                       multi_hypothesis_imputation_sampler,
                       multi_hypothesis_imputation_sampler_params, pad_batch_to_multiple,
                       process_count, process_index, shard_eval_batches, shard_generators,
                       shard_global_batch, shard_global_multi_batch, shard_rows)

__all__ = ["Mesh", "allgather_ragged_1d", "data_parallel_multi_step",
           "data_parallel_multi_step_indexed", "data_parallel_sampler",
           "data_parallel_sampler_params", "data_parallel_step", "fold_seed",
           "init_distributed", "join_rows", "make_mesh", "mesh_route",
           "multi_hypothesis_imputation_sampler", "multi_hypothesis_imputation_sampler_params",
           "pad_batch_to_multiple", "process_count", "process_index", "shard_eval_batches",
           "shard_generators", "shard_global_batch", "shard_global_multi_batch", "shard_rows"]
