from .ctx import (
    activation_spec,
    clear_sharding_ctx,
    current_sharding_ctx,
    set_sharding_ctx,
    shard_activation,
    sharding_ctx,
)
from .rules import (
    Strategy,
    local_shape,
    make_strategy,
    params_shardings,
    placements_for,
    placements_from_spec,
    spec_for,
)

__all__ = [
    "activation_spec",
    "clear_sharding_ctx",
    "current_sharding_ctx",
    "set_sharding_ctx",
    "shard_activation",
    "sharding_ctx",
    "Strategy",
    "local_shape",
    "make_strategy",
    "params_shardings",
    "placements_for",
    "placements_from_spec",
    "spec_for",
]
