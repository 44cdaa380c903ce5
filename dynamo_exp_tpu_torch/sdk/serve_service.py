"""Per-process service entry: run ONE service of a graph.

Counterpart of ``dynamo_exp_tpu/sdk/serve_service.py``: each watcher of
the supervisor runs this module for its service. It builds the
DistributedRuntime, creates the component, resolves ``depends()``
edges, runs the ``@async_on_start`` hooks, then serves every
``@endpoint`` with the service's stats handler.

    python -m dynamo_exp_tpu_torch.sdk.serve_service pkg.module:RootClass \
        --service-name Middle [--config cfg.json]

With ``--num-nodes`` > 1 the process first joins its node group's
process group (``parallel/multihost.py`` ``bringup``, one rank a node:
NCCL on the node's card, gloo on a CPU-only node) and leaves the
``Comm`` in ``dynamo_context["comm"]`` for the service to build its
engine over.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import importlib
import logging
import sys

logger = logging.getLogger("dynamo_exp_tpu_torch.sdk.serve_service")


def load_target(target: str) -> type:
    mod_name, _, cls_name = target.partition(":")
    if not cls_name:
        raise SystemExit(f"target must be module:Class, got {target!r}")
    mod = importlib.import_module(mod_name)
    return getattr(mod, cls_name)


async def join_group(multihost, drt):
    """This node's rank of the multi-node group: one rank a node, on the
    node's first visible card over NCCL, or on the CPU over gloo."""
    import torch

    from ..parallel.comm import resolve_backend
    from ..parallel.mesh import rank_layout
    from ..parallel.multihost import bringup

    kind = "cuda" if torch.cuda.is_available() else "cpu"
    layout = rank_layout(tp=multihost.num_nodes, rank=multihost.node_rank,
                         num_nodes=multihost.num_nodes)
    return await bringup(multihost, discovery=drt.discovery, layout=layout,
                         backend=resolve_backend(None, kind, False), device=layout.device(kind))


async def run_service(
    target: str,
    service_name: str | None,
    config_path: str | None,
    multihost=None,
):
    from ..runtime.annotated import Annotated
    from ..runtime.component import DistributedRuntime
    from ..runtime.config import RuntimeConfig
    from ..runtime.engine import AsyncEngineContext
    from .config import ServiceConfig
    from .dependency import depends as depends_t
    from .service import discover_graph, dynamo_context

    root = load_target(target)
    graph = discover_graph(root)
    spec = next((s for s in graph if s.name == (service_name or graph[-1].name)), None)
    if spec is None:
        raise SystemExit(f"service {service_name!r} not in graph ({[s.name for s in graph]})")

    drt = DistributedRuntime(config=RuntimeConfig.from_settings())
    if multihost is not None and multihost.is_multi_node:
        # The worker that owns the node's card joins the group before
        # anything builds on a device (the supervisor forwards the flags).
        dynamo_context["comm"] = await join_group(multihost, drt)
    component = drt.namespace(spec.namespace).component(spec.component_name)
    dynamo_context.update(
        runtime=drt,
        namespace=spec.namespace,
        component=component,
        endpoints=sorted(spec.endpoints),
        instance_ids={},
    )

    instance = spec.cls()
    ServiceConfig.load(config_path).apply_to(instance, spec.name)

    # Graph edges become live clients before the start hooks run.
    for dep in vars(spec.cls).values():
        if isinstance(dep, depends_t):
            await dep.resolve(drt)
    for hook in spec.on_start:
        await getattr(instance, hook)()

    stats = getattr(instance, spec.stats_method) if spec.stats_method else None
    served = []
    comm = dynamo_context.get("comm")
    # A follower rank of a multi-node group serves nothing: its node's
    # rank 0 takes the requests and drives it.
    endpoints = sorted(spec.endpoints) if comm is None or comm.rank == 0 else []
    for ep_name in endpoints:
        bound = getattr(instance, spec.endpoints[ep_name].__name__)

        def make_handler(fn):
            async def handler(request: dict, context: AsyncEngineContext):
                try:
                    async for item in fn(request):
                        yield Annotated.from_data(item).to_dict()
                except Exception as e:  # error frames travel in-band
                    logger.exception("endpoint handler failed")
                    yield Annotated.from_error(str(e)).to_dict()

            return handler

        s = await component.endpoint(ep_name).serve_endpoint(make_handler(bound),
                                                             stats_handler=stats)
        dynamo_context["instance_ids"][ep_name] = s.instance_id
        served.append(s)

    print(f"service {spec.name} ready ({len(served)} endpoints)", flush=True)
    try:
        await drt.runtime.primary_token.cancelled()
    finally:
        for s in served:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(s.close(), 15)
        stop = getattr(instance, "stop", None)
        if callable(stop):
            stop()
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(drt.close(), 15)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("target", help="pkg.module:RootClass")
    p.add_argument("--service-name", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--num-nodes", type=int, default=1)
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--dist-leader", default="")
    p.add_argument("--dist-port", type=int, default=9911)
    p.add_argument("--deployment", default="default")
    return p


def main(argv: list[str] | None = None) -> None:
    # DYN_LOG / DYN_LOGGING_JSONL aware; service processes inherit
    # DYN_TRACE_FILE for span recording.
    from ..runtime.logging import configure_logging

    configure_logging()
    args = build_parser().parse_args(argv if argv is not None else sys.argv[1:])

    multihost = None
    if args.num_nodes > 1:
        from ..parallel.multihost import MultiNodeConfig

        multihost = MultiNodeConfig(
            num_nodes=args.num_nodes,
            node_rank=args.node_rank,
            leader_addr=args.dist_leader or None,
            dist_port=args.dist_port,
            deployment=args.deployment,
        )

    from ..runtime.runtime import run_until_signalled

    run_until_signalled(run_service(args.target, args.service_name, args.config, multihost))


if __name__ == "__main__":
    main()
