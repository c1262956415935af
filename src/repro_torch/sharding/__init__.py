from repro_torch.sharding.specs import (P, batch_specs, decode_state_specs,
                                        local_shape, local_slice, mesh_sizes,
                                        opt_state_specs, param_specs, place,
                                        placements, shard_tree)

__all__ = ["P", "batch_specs", "decode_state_specs", "local_shape",
           "local_slice", "mesh_sizes", "opt_state_specs", "param_specs",
           "place", "placements", "shard_tree"]
