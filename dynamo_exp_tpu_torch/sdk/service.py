"""Service decorators and the per-process runtime context.

Counterpart of ``dynamo_exp_tpu/sdk/service.py``: the ``@service`` class
decorator, ``@endpoint``, ``@async_on_start``, ``@stats_handler``, graph
discovery over ``depends()`` edges, and the ``dynamo_context`` global
that ``serve_service`` fills before it builds the service. A service
asks for cards with ``resources={"gpu": n}`` (the JAX package spells it
``"tpu"``).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable

# Filled by serve_service before the service class is instantiated:
# {"runtime": DistributedRuntime, "component": Component, "namespace": str,
#  "endpoints": [names], "instance_ids": {endpoint: id}} and, for a
# worker of a multi-node group, "comm" (its parallel.comm.Comm).
dynamo_context: dict[str, Any] = {}


@dataclass
class ServiceSpec:
    """Everything the supervisor needs to launch one service class."""

    cls: type
    name: str
    namespace: str = "dynamo"
    workers: int = 1
    # Resource request, e.g. {"gpu": 1} cards or {"cpu": "2", "memory": "2Gi"}.
    resources: dict[str, Any] = field(default_factory=dict)
    enabled: bool = True
    endpoints: dict[str, Callable] = field(default_factory=dict)
    on_start: list[str] = field(default_factory=list)
    # Method name marked @stats_handler: () -> dict, scraped by the
    # stats plane (the planner's and the KV router's load signal).
    stats_method: str | None = None

    @property
    def component_name(self) -> str:
        return self.name

    @property
    def gpus(self) -> int:
        return int(self.resources.get("gpu", 0))


def service(
    dynamo: dict | None = None,
    resources: dict | None = None,
    workers: int = 1,
    name: str | None = None,
):
    """Class decorator registering a service.

    ``@service(dynamo={"namespace": "ns"}, resources={"gpu": 1}, workers=2)``
    """

    def wrap(cls: type) -> type:
        dyn = dynamo or {}
        spec = ServiceSpec(
            cls=cls,
            name=name or cls.__name__,
            namespace=dyn.get("namespace", "dynamo"),
            workers=workers,
            resources=resources or {},
            enabled=dyn.get("enabled", True),
        )
        for attr, val in inspect.getmembers(cls):
            ep_name = getattr(val, "__dynamo_endpoint__", None)
            if ep_name is not None:
                spec.endpoints[ep_name] = val
            if getattr(val, "__dynamo_on_start__", False):
                spec.on_start.append(attr)
            if getattr(val, "__dynamo_stats__", False):
                spec.stats_method = attr
        cls.__dynamo_spec__ = spec
        return cls

    return wrap


def endpoint(name: str | None = None):
    """Mark an async-generator method ``async def gen(self, request:
    dict)`` as a served endpoint; the serving layer wraps what it yields
    into the Annotated envelope. Bare ``@endpoint`` works too."""

    def wrap(fn):
        fn.__dynamo_endpoint__ = name or fn.__name__
        return fn

    if callable(name):
        fn, name = name, None
        return wrap(fn)
    return wrap


def async_on_start(fn):
    """Run after the runtime context exists, before endpoints serve."""
    fn.__dynamo_on_start__ = True
    return fn


def stats_handler(fn):
    """Mark a ``def stats(self) -> dict`` method as the service's load
    report, scraped by the stats plane: the planner's KV-load signal and
    the KV router's selector both read it."""
    fn.__dynamo_stats__ = True
    return fn


def get_spec(cls: type) -> ServiceSpec:
    spec = getattr(cls, "__dynamo_spec__", None)
    if spec is None:
        raise TypeError(f"{cls.__name__} is not decorated with @service")
    return spec


def discover_graph(root: type) -> list[ServiceSpec]:
    """The dependency closure of ``root``, dependencies first: graphs
    link services by ``depends()`` class attributes, and the serve CLI
    launches every service in the closure."""
    from .dependency import depends as _depends

    order: list[ServiceSpec] = []
    seen: set[type] = set()

    def visit(cls: type) -> None:
        if cls in seen:
            return
        seen.add(cls)
        for dep in vars(cls).values():
            if isinstance(dep, _depends):
                visit(dep.target)
        order.append(get_spec(cls))

    visit(root)
    return order
