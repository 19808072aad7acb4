"""Serving over several devices and multi-process evaluation (port of
``dposer_tpu/parallel``'s serving half): see ``sharding.py``."""
from .sharding import (Mesh, allgather_ragged_1d, data_parallel_sampler, fold_seed,
                       init_distributed, join_rows, make_mesh, mesh_route,
                       multi_hypothesis_imputation_sampler, pad_batch_to_multiple,
                       process_count, process_index, shard_eval_batches, shard_generators,
                       shard_rows)

__all__ = ["Mesh", "allgather_ragged_1d", "data_parallel_sampler", "fold_seed",
           "init_distributed", "join_rows", "make_mesh", "mesh_route",
           "multi_hypothesis_imputation_sampler", "pad_batch_to_multiple", "process_count",
           "process_index", "shard_eval_batches", "shard_generators", "shard_rows"]
