"""Multi-card training of the port: process groups, meshes, DDP, FSDP and
tensor parallelism (`parallel/mesh.py`)."""
from daclip_torch.parallel.mesh import (Mesh, all_reduce_mean, apply_ddp, apply_fsdp,
                                        apply_tensor_parallel, barrier, data_group,
                                        finish_grads, full_tensors, grad_norm,
                                        initialize_distributed, is_distributed,
                                        load_model_state, load_optimizer_state, load_tensors,
                                        local_tensor, make_optimizer, mesh_from_spec,
                                        model_state, no_sync, optimizer_layout,
                                        optimizer_state, parallelize,
                                        parse_mesh, rank, rank_seed, unwrap, world_size)

__all__ = ["Mesh", "all_reduce_mean", "apply_ddp", "apply_fsdp", "apply_tensor_parallel",
           "barrier", "data_group", "finish_grads", "full_tensors", "grad_norm",
           "initialize_distributed", "is_distributed", "load_model_state",
           "load_optimizer_state", "load_tensors", "local_tensor", "make_optimizer",
           "mesh_from_spec", "model_state", "no_sync", "optimizer_layout", "optimizer_state",
           "parallelize", "parse_mesh", "rank", "rank_seed", "unwrap", "world_size"]
