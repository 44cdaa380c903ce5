"""``deploy`` CLI: build, render, push, list, deploy.

Counterpart of ``dynamo_exp_tpu/deploy/cli.py``, the same commands and
flags, and ``list`` (the store's artifacts), which the JAX CLI names in
its docstring; the store is reached through the port's
``http/client.py``, not aiohttp.

    python -m dynamo_exp_tpu_torch.deploy.cli build \
        dynamo_exp_tpu_torch.examples.llm.graphs.agg:Frontend -o agg.tar.gz \
        -f dynamo_exp_tpu_torch/examples/llm/configs/agg.json
    python -m dynamo_exp_tpu_torch.deploy.cli render agg.tar.gz --image my/img > k8s.yaml
    python -m dynamo_exp_tpu_torch.deploy.cli push agg.tar.gz --store http://host:7070
    python -m dynamo_exp_tpu_torch.deploy.cli list --store http://host:7070
    python -m dynamo_exp_tpu_torch.deploy.cli deploy NAME VERSION --store ... --image ...
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from .artifact import build_artifact, read_manifest
from .k8s import DEFAULT_IMAGE, render_graph_manifests, to_yaml


def _cmd_build(args) -> int:
    manifest = build_artifact(
        args.target, args.output, name=args.name, config_path=args.config,
        src_root=args.src_root, packages=args.packages.split(",") if args.packages else None)
    print(json.dumps({"name": manifest.name, "version": manifest.version,
                      "services": [s.name for s in manifest.services]}))
    return 0


def _cmd_render(args) -> int:
    docs = render_graph_manifests(read_manifest(args.artifact), image=args.image,
                                  deployment=args.deployment)
    sys.stdout.write(to_yaml(docs))
    return 0


async def _store_call(method: str, url: str, payload=None) -> int:
    """One store request; its JSON answer printed; 0 on a 200."""
    from ..http import client

    r = await client.request(url, method, payload)
    print(json.dumps(r.json()))
    return 0 if r.status == 200 else 1


def _cmd_push(args) -> int:
    with open(args.artifact, "rb") as f:
        body = f.read()
    return asyncio.run(_store_call("POST", f"{args.store}/api/v1/artifacts", body))


def _cmd_list(args) -> int:
    return asyncio.run(_store_call("GET", f"{args.store}/api/v1/artifacts"))


def _cmd_deploy(args) -> int:
    payload = {"artifact": args.name, "version": args.version, "image": args.image,
               "name": args.deployment or args.name}
    return asyncio.run(_store_call("POST", f"{args.store}/api/v1/deployments", payload))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="deploy", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="pack an SDK graph into an artifact")
    b.add_argument("target", help="pkg.module:RootService")
    b.add_argument("-o", "--output", required=True)
    b.add_argument("-f", "--config", default=None)
    b.add_argument("--name", default=None)
    b.add_argument("--src-root", default=".")
    b.add_argument("--packages", default=None,
                   help="comma-separated packages to pack (default: the graph's root package)")

    r = sub.add_parser("render", help="render K8s manifests for an artifact")
    r.add_argument("artifact")
    r.add_argument("--image", default=DEFAULT_IMAGE)
    r.add_argument("--deployment", default=None)

    pu = sub.add_parser("push", help="upload an artifact to the api-store")
    pu.add_argument("artifact")
    pu.add_argument("--store", required=True)

    ls = sub.add_parser("list", help="list the api-store's artifacts")
    ls.add_argument("--store", required=True)

    d = sub.add_parser("deploy", help="create a deployment record in the store")
    d.add_argument("name")
    d.add_argument("version")
    d.add_argument("--store", required=True)
    d.add_argument("--image", default=DEFAULT_IMAGE)
    d.add_argument("--deployment", default=None)

    args = p.parse_args(argv)
    return {"build": _cmd_build, "render": _cmd_render, "push": _cmd_push,
            "list": _cmd_list, "deploy": _cmd_deploy}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
