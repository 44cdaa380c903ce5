"""Discovery and the request / response planes (counterpart of
``dynamo_exp_tpu/runtime/transports/``). The fault-injection planes
(``chaos.py``) wait for a later slice (ROADMAP Queue 1)."""

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
