"""Declarative serve config (reference: python/ray/serve/schema.py
ServeDeploySchema / ServeApplicationSchema + `serve deploy`).

A config file (YAML or JSON) describes applications by import path plus
per-deployment overrides; `deploy_config` imports each target, applies the
overrides through `.options()`, and `serve.run`s it. The same schema
round-trips from `build_app_config`.

    applications:
      - name: summarizer
        route_prefix: /sum
        import_path: my_pkg.serving:app       # BoundDeployment or builder fn
        args: {model: t5-small}               # passed when target is a fn
        deployments:
          - name: Summarizer
            num_replicas: 2
            user_config: {beam: 4}
            max_ongoing_requests: 16

`user_config` reaches the replica through `instance.reconfigure(...)`
(replica.py) when the deployment class defines it — e.g. an LLMServer
deployment takes `user_config: {decode_chunk: 16}` to retune the fused
decode-chunk length at deploy time without a param reload (llm.py
LLMServer.reconfigure).
"""

import dataclasses
import importlib
import json
from typing import Any, Dict, List, Optional

from .deployment import BoundDeployment, map_bound

_DEPLOYMENT_OVERRIDES = ("num_replicas", "user_config",
                         "max_ongoing_requests", "ray_actor_options",
                         "autoscaling_config")


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    user_config: Optional[Dict] = None
    max_ongoing_requests: Optional[int] = None
    ray_actor_options: Optional[Dict] = None
    autoscaling_config: Optional[Dict] = None

    def overrides(self) -> Dict[str, Any]:
        out = {}
        for f in _DEPLOYMENT_OVERRIDES:
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out


@dataclasses.dataclass
class ServeApplicationSchema:
    import_path: str
    name: str = "default"
    route_prefix: Optional[str] = None
    args: Optional[Dict] = None
    deployments: List[DeploymentSchema] = dataclasses.field(
        default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict) -> "ServeApplicationSchema":
        deps = [DeploymentSchema(**x) for x in d.get("deployments", [])]
        return cls(import_path=d["import_path"], name=d.get("name", "default"),
                   route_prefix=d.get("route_prefix"),
                   args=d.get("args"), deployments=deps)


@dataclasses.dataclass
class ServeDeploySchema:
    applications: List[ServeApplicationSchema]
    http_options: Optional[Dict] = None

    @classmethod
    def from_dict(cls, d: Dict) -> "ServeDeploySchema":
        apps = [ServeApplicationSchema.from_dict(a)
                for a in d.get("applications", [])]
        if not apps:
            raise ValueError("config has no applications")
        return cls(applications=apps, http_options=d.get("http_options"))


def load_config(path_or_dict) -> ServeDeploySchema:
    if isinstance(path_or_dict, dict):
        return ServeDeploySchema.from_dict(path_or_dict)
    with open(path_or_dict) as f:
        text = f.read()
    try:
        import yaml
        data = yaml.safe_load(text)
    except ImportError:  # pragma: no cover - yaml is in the image
        data = json.loads(text)
    return ServeDeploySchema.from_dict(data)


def _import_target(import_path: str):
    """'pkg.module:attr' (or dotted fallback) → the object."""
    if ":" in import_path:
        mod_name, attr = import_path.split(":", 1)
    else:
        mod_name, _, attr = import_path.rpartition(".")
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _apply_overrides(bound: BoundDeployment,
                     deployments: List[DeploymentSchema]) -> BoundDeployment:
    """Rebind the app graph with per-deployment option overrides by name."""
    by_name = {d.name: d.overrides() for d in deployments}
    if not by_name:
        return bound

    seen = {}

    def rebuild(node: BoundDeployment) -> BoundDeployment:
        if id(node) in seen:
            return seen[id(node)]
        args = tuple(map_bound(a, rebuild) for a in node.args)
        kwargs = {k: map_bound(v, rebuild) for k, v in node.kwargs.items()}
        dep = node.deployment
        ov = by_name.get(dep.name)
        if ov:
            dep = dep.options(**ov)
        out = dep.bind(*args, **kwargs)
        seen[id(node)] = out
        return out

    return rebuild(bound)


def deploy_config(path_or_dict, *, start_http: bool = True) -> Dict[str, Any]:
    """Deploy every application in a config (ref: `serve deploy` /
    serve.run_many). Returns {app_name: handle}."""
    from . import api as serve_api

    schema = load_config(path_or_dict)
    handles = {}
    for app in schema.applications:
        target = _import_target(app.import_path)
        if isinstance(target, BoundDeployment):
            bound = target
        elif callable(target):
            bound = target(**(app.args or {}))
        else:
            raise TypeError(
                f"{app.import_path} is neither a bound deployment nor a "
                f"builder function")
        if not isinstance(bound, BoundDeployment):
            raise TypeError(f"{app.import_path} did not produce a bound "
                            f"deployment")
        bound = _apply_overrides(bound, app.deployments)
        handles[app.name] = serve_api.run(
            bound, name=app.name, route_prefix=app.route_prefix)
    if start_http:
        serve_api.start(http_options=schema.http_options or None)
    return handles


def build_app_config(bound: BoundDeployment, import_path: str,
                     name: str = "default",
                     route_prefix: Optional[str] = None) -> Dict:
    """The config dict for a bound app (ref: `serve build`): callers write
    it to YAML and hand it to `deploy_config` / the CLI."""
    deps = []
    for node in bound.walk():
        d = node.deployment
        cfg = d.config
        deps.append({k: v for k, v in {
            "name": d.name,
            "num_replicas": cfg.num_replicas,
            "user_config": cfg.user_config,
            "max_ongoing_requests": cfg.max_ongoing_requests,
        }.items() if v is not None})
    return {"applications": [{
        "name": name, "import_path": import_path,
        **({"route_prefix": route_prefix} if route_prefix else {}),
        "deployments": deps,
    }]}
