from repro_torch.sharding.context import (axis_rules, current_rules,  # noqa: F401
                                          Pick, local_shape, local_slice,
                                          shard, spec_for)
from repro_torch.sharding.rules import (RULES, mesh_coords,  # noqa: F401
                                        mesh_sizes, rules_for_mesh)
