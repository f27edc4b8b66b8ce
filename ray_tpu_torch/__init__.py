"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The package mirrors `ray_tpu`'s layout. Its runtime (`api.py`, `actor.py`,
`remote_function.py`, `_private/`, `_native/`) is the port's own copy of
`ray_tpu`'s single-host task/actor runtime: `init`, `@remote` tasks and
actors, `get`/`put`/`wait`, a shm object store and a resource-aware
scheduler with CUDA cards as the "GPU" resource (`num_gpus`). Beside it sit
the paged Llama serving engine, the Llama training step and the trainer's
world around it, the mesh layer, and RLlib's core for an NVIDIA H100. Every
Pallas kernel of the JAX package has a CUDA C++ counterpart under
`ops/csrc/`, built with nvcc at first use. The package imports torch,
numpy and cloudpickle only: never jax, flax or any `ray_tpu` module.

This module imports nothing: the runtime's API (`init`, `remote`, `get`,
...), `resolve_device` and the subpackages load on first use, so a worker
that runs a plain task starts without torch, and `import
ray_tpu_torch.train` needs neither the runtime nor cloudpickle.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

_API = ("available_resources", "cancel", "cluster_address", "cluster_resources", "get",
        "get_actor", "init", "is_initialized", "kill", "nodes", "object_ref_from_id", "put",
        "remote", "shutdown", "timeline", "wait")
# name -> the module that defines it, imported on first use
_LAZY = {**{name: ".api" for name in _API},
         "ObjectRef": "._private.object_ref", "ObjectRefGenerator": "._private.object_ref",
         "DynamicObjectRefGenerator": "._private.object_ref",
         "ActorClass": ".actor", "ActorHandle": ".actor", "method": ".actor",
         "exit_actor": ".actor", "LoggingConfig": ".logging_config",
         "RemoteFunction": ".remote_function", "get_runtime_context": ".runtime_context",
         "get_gpu_ids": ".runtime_context", "resolve_device": ".device"}
_LAZY_SUBMODULES = ("api", "exceptions", "parallel", "models", "ops", "train", "serve",
                    "rllib", "util", "tune", "dag", "workflow")

__all__ = sorted(_LAZY) + ["exceptions"]


def __getattr__(name):
    import importlib
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    elif name in _LAZY_SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute '{name}'")
    globals()[name] = value
    return value
