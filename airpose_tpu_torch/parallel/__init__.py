from .mesh import (Mesh, all_reduce_mean, batch_rows, data_parallel, gather_params_tp,
                   gather_rows, global_batch_norm, make_mesh, make_mesh_2d, param_spec,
                   shard_batch, shard_params_tp)
from .launch import init_from_env, init_in_process, spawn

__all__ = ["Mesh", "all_reduce_mean", "batch_rows", "data_parallel", "gather_params_tp",
           "gather_rows", "global_batch_norm", "init_from_env", "init_in_process", "make_mesh", "make_mesh_2d",
           "param_spec", "shard_batch", "shard_params_tp", "spawn"]
