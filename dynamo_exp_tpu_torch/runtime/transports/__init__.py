"""Discovery and the request / response planes (counterpart of
``dynamo_exp_tpu/runtime/transports/``), and the seeded fault-injection
planes that wrap them (``chaos.py``)."""

from .base import (
    Discovery,
    EndpointAddress,
    Handler,
    InstanceInfo,
    Lease,
    RequestPlane,
    ServedEndpoint,
    StatsHandler,
)
from .inproc import InProcDiscovery, InProcRequestPlane

__all__ = [
    "Discovery",
    "EndpointAddress",
    "Handler",
    "InProcDiscovery",
    "InProcRequestPlane",
    "InstanceInfo",
    "Lease",
    "RequestPlane",
    "ServedEndpoint",
    "StatsHandler",
]
