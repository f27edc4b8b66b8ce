"""ray_tpu_torch.serve — model serving on the port's runtime (reference:
python/ray/serve).

Deployments are async replica actors; handles route with
power-of-two-choices and prefix affinity; `@serve.batch` coalesces
requests; the HTTP proxy and the OpenAI app ride on the handles;
`serve/llm.py` is the continuous-batching LLM replica and `serve/pd.py`
its prefill/decode split. The names are the JAX package's, name for name.

Every name but `deployment` loads on first use (module `__getattr__`, as
the package root does): the serve controller and the HTTP proxy import this
package in processes that must not load torch, and only `llm`, `pd` and
`openai_api` import it.
"""

# `deployment` names both a submodule and the decorator: bound here, so that
# importing the submodule first (as the controller's process does when it
# unpickles a DeploymentConfig) cannot leave the module in the decorator's
# place. The module holds dataclasses only.
from .deployment import deployment

# name -> the submodule that defines it, imported on first use
_LAZY = {
    **{name: ".api" for name in (
        "HTTPOptions", "delete", "get_app_handle", "get_deployment_handle",
        "get_replica_context", "grpc_port", "run", "run_many", "shutdown",
        "shutdown_async", "start", "status")},
    "ingress": ".asgi",
    "batch": ".batching",
    **{name: ".deployment" for name in (
        "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig")},
    "DeploymentHandle": ".handle", "DeploymentResponse": ".handle",
    "get_multiplexed_model_id": ".multiplex", "multiplexed": ".multiplex",
    **{name: ".openai_api" for name in (
        "ByteTokenizer", "OpenAIIngress", "build_openai_app")},
    **{name: ".pd" for name in ("DecodeServer", "PDServer", "PrefillServer")},
    "Request": ".proxy", "Response": ".proxy",
    "build_app_config": ".schema", "deploy_config": ".schema",
}

__all__ = [
    "AutoscalingConfig", "Deployment", "DeploymentConfig", "DeploymentHandle",
    "DeploymentResponse", "Request", "Response", "batch", "build_app_config",
    "Application", "delete", "deploy_config", "deployment",
    "get_app_handle", "get_deployment_handle", "get_replica_context",
    "HTTPOptions", "run_many", "shutdown_async",
    "grpc_port",
    "get_multiplexed_model_id", "ingress", "multiplexed", "run", "shutdown",
    "start", "status", "PrefillServer", "DecodeServer", "PDServer",
    "ByteTokenizer", "OpenAIIngress", "build_openai_app",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'ray_tpu_torch.serve' has no attribute '{name}'")
    import importlib
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
