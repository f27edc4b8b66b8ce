"""`python -m ray_tpu_torch.serve <cmd>` — declarative deploy CLI (reference:
python/ray/serve/scripts.py `serve deploy|status|shutdown`).

    python -m ray_tpu_torch.serve deploy config.yaml
    python -m ray_tpu_torch.serve status
    python -m ray_tpu_torch.serve shutdown

`deploy` attaches to a running session via RTPT_ADDRESS when one exists
(so the deployment lands in the shared cluster); otherwise it starts a local
session and blocks to keep serving.
"""

import argparse
import json
import os
import sys
import time


def _attach_or_init():
    import ray_tpu_torch as rt
    if os.environ.get("RTPT_ADDRESS"):
        try:
            rt.init(address="auto")
            return True
        except ConnectionError:
            pass
    rt.init()
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("deploy", help="deploy applications from a config")
    dp.add_argument("config", help="YAML/JSON config file")
    dp.add_argument("--non-blocking", action="store_true",
                    help="return after deploying (default blocks when this "
                    "process owns the session)")
    sub.add_parser("status", help="print serve status as JSON")
    sub.add_parser("shutdown", help="tear down all serve applications")
    args = ap.parse_args(argv)

    from . import api as serve_api

    if args.cmd == "deploy":
        attached = _attach_or_init()
        from .schema import deploy_config
        handles = deploy_config(args.config)
        print(json.dumps({"deployed": sorted(handles),
                          "status": serve_api.status()}, default=str))
        if not attached and not args.non_blocking:
            print("serving (Ctrl-C to stop)", file=sys.stderr)
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass
        return 0
    if args.cmd == "status":
        _attach_or_init()
        print(json.dumps(serve_api.status(), default=str))
        return 0
    if args.cmd == "shutdown":
        _attach_or_init()
        serve_api.shutdown()
        print("{}")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
