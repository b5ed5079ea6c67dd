from repro_torch.sharding.context import (axis_rules, current_rules,  # noqa: F401
                                          local_shape, shard, spec_for)
from repro_torch.sharding.rules import RULES, rules_for_mesh  # noqa: F401
