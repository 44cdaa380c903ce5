"""Graph supervisor: one process per service worker, card slots allocated.

Counterpart of ``dynamo_exp_tpu/sdk/serve.py``: a watcher a worker
process, restarted with backoff on an unexpected exit (a worker that
keeps crashing is given up on, and then ``serve`` exits with an error),
a ``{namespace}.supervisor.control`` endpoint through which the
planner's ``LocalConnector`` adds and removes workers, and the CLI.

    python -m dynamo_exp_tpu_torch.sdk.serve pkg.module:RootClass \
        [-f config.json] [--coordinator HOST:PORT | --start-coordinator] \
        [--service-name OnlyThisOne] [--cuda-devices 0,0]

``--cuda-devices`` (env ``DYN_CUDA_DEVICES``) lists the card slots, one
a visible card by default; a repeated ordinal puts that many workers on
one card (the JAX CLI's ``--tpu-chips`` counts chips instead). Ordinals
count among the cards this process sees (its ``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
import os
import sys
import time

logger = logging.getLogger("dynamo_exp_tpu_torch.sdk.serve")

MAX_RESTARTS = 3
RESTART_WINDOW_S = 60.0


class Watcher:
    """One service worker process, restarted on unexpected death."""

    def __init__(self, spec, worker_idx: int, argv: list[str], env: dict[str, str]):
        self.spec = spec
        self.worker_idx = worker_idx
        self.argv = argv
        self.env = env
        self.proc: asyncio.subprocess.Process | None = None
        self.restarts: list[float] = []
        self.stopping = False

    @property
    def name(self) -> str:
        return f"{self.spec.name}[{self.worker_idx}]"

    async def start(self) -> None:
        self.proc = await asyncio.create_subprocess_exec(*self.argv, env={**os.environ, **self.env})
        logger.info("started %s (pid %d)", self.name, self.proc.pid)

    async def supervise(self) -> None:
        while not self.stopping:
            rc = await self.proc.wait()
            if self.stopping:
                return
            now = time.monotonic()
            self.restarts = [t for t in self.restarts if now - t < RESTART_WINDOW_S] + [now]
            if len(self.restarts) > MAX_RESTARTS:
                raise RuntimeError(
                    f"{self.name} crashed {len(self.restarts)} times in "
                    f"{RESTART_WINDOW_S:.0f}s (rc={rc}); giving up"
                )
            logger.warning("%s exited rc=%s; restarting", self.name, rc)
            await asyncio.sleep(min(2 ** (len(self.restarts) - 1), 10))
            await self.start()

    async def stop(self, timeout: float = 20.0) -> None:
        self.stopping = True
        if self.proc is None or self.proc.returncode is not None:
            return
        self.proc.terminate()  # SIGTERM -> graceful drain in the child
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self.proc.wait(), timeout)
        if self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()


class Supervisor:
    """Dynamic watcher set over a service graph, taking live scale
    commands: the planner's LocalConnector drives ``add_worker`` /
    ``remove_worker`` through a control endpoint on the coordinator."""

    def __init__(
        self, target: str, graph, config, allocator, endpoint: str,
        multihost_argv: list[str] | None = None,
    ):
        self.target = target
        self.specs = {s.name: s for s in graph}
        self.config = config
        self.allocator = allocator
        self.endpoint = endpoint
        # Extra serve_service flags for the (single) card service when
        # this host is one node of a multi-node group.
        self.multihost_argv = multihost_argv
        self.watchers: dict[str, list[Watcher]] = {s.name: [] for s in graph}
        self._next_idx = {s.name: 0 for s in graph}
        self._tasks: dict[Watcher, asyncio.Task] = {}
        self.failed: asyncio.Future | None = None

    def _build_watcher(self, spec) -> Watcher:
        from .config import ENV_VAR

        env = {
            "DYN_RUNTIME_COORDINATOR_ENDPOINT": self.endpoint,
            ENV_VAR: self.config.dumps(),
            **self.allocator.assign(spec.name, spec.gpus),
        }
        argv = [sys.executable, "-m", "dynamo_exp_tpu_torch.sdk.serve_service", self.target,
                "--service-name", spec.name]
        if self.multihost_argv and spec.gpus > 0:
            argv += self.multihost_argv
        idx = self._next_idx[spec.name]
        self._next_idx[spec.name] += 1
        return Watcher(spec, idx, argv, env)

    async def add_worker(self, service_name: str) -> bool:
        from .allocator import AllocationError

        spec = self.specs.get(service_name)
        if spec is None:
            return False
        try:
            w = self._build_watcher(spec)
        except AllocationError as e:
            logger.warning("add_worker(%s): %s", service_name, e)
            return False
        try:
            await w.start()
        except Exception:
            # A failed spawn returns its slots, or repeated planner
            # retries would drain the budget for good.
            self.allocator.release(w.env)
            logger.exception("add_worker(%s): spawn failed", service_name)
            return False
        self.watchers[service_name].append(w)
        self._tasks[w] = asyncio.ensure_future(self._supervise(w))
        return True

    async def remove_worker(self, service_name: str) -> bool:
        """Stop the newest worker of a service (SIGTERM: the child
        drains, deregisters and revokes its lease on exit)."""
        ws = self.watchers.get(service_name) or []
        if not ws:
            return False
        w = ws.pop()
        task = self._tasks.pop(w, None)
        if task is not None:
            task.cancel()
        await w.stop()
        self.allocator.release(w.env)
        return True

    def counts(self) -> dict[str, int]:
        return {name: len(ws) for name, ws in self.watchers.items()}

    async def _supervise(self, w: Watcher) -> None:
        try:
            await w.supervise()
        except Exception as exc:  # crash-looped: surface to serve_graph
            if self.failed is not None and not self.failed.done():
                self.failed.set_exception(exc)

    def _initial_workers(self, spec) -> int:
        """The config's ``ServiceArgs: {workers: N}`` overrides the
        decorator's count."""
        svc_args = self.config.get(spec.name).get("ServiceArgs") or {}
        return int(svc_args.get("workers", spec.workers))

    async def start_initial(self) -> None:
        self.failed = asyncio.get_running_loop().create_future()
        for spec in self.specs.values():
            for _ in range(self._initial_workers(spec)):
                if not await self.add_worker(spec.name):
                    raise RuntimeError(f"failed to start {spec.name}")

    async def stop_all(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()
        await asyncio.gather(*[w.stop() for ws in self.watchers.values() for w in ws],
                             return_exceptions=True)

    async def serve_control(self, drt, namespace: str):
        """The control endpoint the planner's LocalConnector talks to:
        {"op": "add"|"remove"|"list", "service": name} -> one reply
        frame {"ok": bool, "counts": {service: n}}."""

        async def handler(request: dict, context=None):
            op = request.get("op")
            service = request.get("service", "")
            ok = True
            if op == "add":
                ok = await self.add_worker(service)
            elif op == "remove":
                ok = await self.remove_worker(service)
            elif op != "list":
                ok = False
            yield {"data": {"ok": ok, "counts": self.counts()}}

        ep = drt.namespace(namespace).component("supervisor").endpoint("control")
        return await ep.serve_endpoint(handler)


def multihost_argv(args, graph) -> list[str] | None:
    """serve_service flags for the one card service of a multi-node
    group: each node's worker process joins the group, not this
    supervisor."""
    if args.num_nodes <= 1:
        return None
    card_specs = [s for s in graph if s.gpus > 0]
    if len(card_specs) != 1 or card_specs[0].workers != 1:
        raise SystemExit(
            "--num-nodes > 1 needs --service-name selecting exactly one card service "
            "with workers=1 (one joined process per node)"
        )
    argv = ["--num-nodes", str(args.num_nodes), "--node-rank", str(args.node_rank),
            "--deployment", args.deployment, "--dist-port", str(args.dist_port)]
    if args.dist_leader:
        argv += ["--dist-leader", args.dist_leader]
    return argv


async def serve_graph(args) -> None:
    from ..runtime.component import DistributedRuntime
    from ..runtime.config import RuntimeConfig
    from ..runtime.transports.coordinator import CoordinatorServer
    from .allocator import CudaAllocator
    from .config import ServiceConfig
    from .serve_service import load_target
    from .service import discover_graph

    root = load_target(args.target)
    graph = discover_graph(root)
    if args.service_name:
        graph = [s for s in graph if s.name == args.service_name]
        if not graph:
            raise SystemExit(f"no service named {args.service_name!r}")
    config = ServiceConfig.load(args.config)
    allocator = CudaAllocator(args.cuda_devices)
    mh_argv = multihost_argv(args, graph)

    coordinator = None
    endpoint = args.coordinator
    if args.start_coordinator:
        coordinator = CoordinatorServer("127.0.0.1", args.coordinator_port)
        await coordinator.start()
        endpoint = coordinator.address
        print(f"coordinator on {endpoint}", flush=True)
    if not endpoint:
        raise SystemExit("need --coordinator or --start-coordinator")

    sup = Supervisor(args.target, graph, config, allocator, endpoint, multihost_argv=mh_argv)
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=endpoint))
    control = None
    try:
        control = await sup.serve_control(drt, graph[0].namespace)
        await sup.start_initial()
        print(f"serving {sum(sup.counts().values())} workers: {sup.counts()}", flush=True)
        await sup.failed  # until a watcher gives up, or this task is cancelled
    finally:
        await sup.stop_all()
        if control is not None:
            await control.close()
        await drt.close()
        if coordinator is not None:
            await coordinator.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("target", help="pkg.module:RootClass")
    p.add_argument("-f", "--config", default=None, help="service config (JSON)")
    p.add_argument("--coordinator", default=os.environ.get("DYN_COORDINATOR", ""))
    p.add_argument("--start-coordinator", action="store_true")
    p.add_argument("--coordinator-port", type=int, default=0)
    p.add_argument("--service-name", default=None, help="run one service only")
    p.add_argument("--cuda-devices", default=None,
                   help="card slots, ordinals among the visible cards (e.g. 0,0: two workers "
                        "on the first); "
                        "default: env DYN_CUDA_DEVICES, else one slot a visible card")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="nodes of the card service's multi-node group")
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--dist-leader", default="",
                   help="rank-0 host:port; empty = discover it through the coordinator")
    p.add_argument("--dist-port", type=int, default=9911,
                   help="port rank 0 binds for the group's TCPStore")
    p.add_argument("--deployment", default="default",
                   help="leader-key namespace for multi-node discovery")
    return p


def main(argv: list[str] | None = None) -> None:
    from ..runtime.logging import configure_logging

    configure_logging()
    args = build_parser().parse_args(argv if argv is not None else sys.argv[1:])
    from ..runtime.runtime import run_until_signalled

    run_until_signalled(serve_graph(args))


if __name__ == "__main__":
    main()
