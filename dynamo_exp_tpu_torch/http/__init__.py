"""The port's HTTP tier: the OpenAI ingress (``service.py``), its
admission control and metrics, the client, and the plain wire
(``wire.py``) that the small services share.

The public names load their module on first use, so that a process that
needs only the wire (the api-store) does not import the OpenAI pipeline
and torch with it.
"""

import importlib

_HOME = {
    "AdmissionController": "admission",
    "RequestShedError": "admission",
    "ServiceOverloadedError": "admission",
    "ServiceMetrics": "metrics",
    "HttpService": "service",
    "ModelManager": "service",
    "build_pipeline_engine": "service",
}

__all__ = sorted(_HOME)


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_HOME[name]}", __name__), name)
