"""Global name registries: the port's copy of `ray_tpu.tune.registry`
(reference: python/ray/tune/registry.py register_env / register_trainable).
`rllib.env_runner.resolve_env_creator` looks names up here first.

Process-local dicts: creators pickle into trial/runner actors BY VALUE
(cloudpickle), so workers don't need the registration call to have run —
the resolved callable travels with the spec, unlike the reference's
GCS-backed KV registry (its cross-language indirection buys nothing
single-language)."""

from typing import Any, Callable, Dict, Optional

_ENVS: Dict[str, Callable] = {}
_TRAINABLES: Dict[str, Any] = {}


def register_env(name: str, env_creator: Callable) -> None:
    """`env_creator(env_config) -> gym.Env`; algorithms then accept
    `.environment("<name>")` (ref: tune/registry.py register_env)."""
    if not callable(env_creator):
        raise TypeError("env_creator must be callable")
    _ENVS[name] = env_creator


def get_env_creator(name: str) -> Optional[Callable]:
    return _ENVS.get(name)


def register_trainable(name: str, trainable) -> None:
    """Register a function/class trainable for `tune.run("<name>")`
    (ref: tune/registry.py register_trainable)."""
    if not callable(trainable):
        raise TypeError("trainable must be callable")
    _TRAINABLES[name] = trainable


def get_trainable(name: str):
    t = _TRAINABLES.get(name)
    if t is None:
        raise ValueError(
            f"unknown trainable {name!r}; register_trainable() it first "
            f"(known: {sorted(_TRAINABLES)})")
    return t
