"""Utility belt (reference: python/ray/util): placement groups and
scheduling strategies of the port's runtime, GPU topology (`gpu`),
metrics and tracing, and on first use `ActorPool`, `Queue`, `Pool`, the
state API (`state`) and `inspect_serializability`."""

from .placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    remove_placement_group,
)
from .scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "get_current_placement_group", "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
]


_LAZY = {
    "ActorPool": ".actor_pool",
    "Queue": ".queue",
    "Pool": ".multiprocessing",
    "metrics": ".metrics",
    "gpu": ".gpu",
    "state": ".state",
    "inspect_serializability": ".check_serialize",
}


def __getattr__(name):
    mod_path = _LAZY.get(name)
    if mod_path is None:
        raise AttributeError(name)
    import importlib
    mod = importlib.import_module(mod_path, __name__)
    # submodule names ("metrics", "gpu") resolve to the module itself;
    # class/function names resolve to the attribute inside it
    if hasattr(mod, name) and mod.__name__.rsplit(".", 1)[-1] != name:
        return getattr(mod, name)
    return mod
