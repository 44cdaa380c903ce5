from .admission import AdmissionController, RequestShedError, ServiceOverloadedError
from .metrics import ServiceMetrics
from .service import HttpService, ModelManager, build_pipeline_engine

__all__ = [
    "AdmissionController",
    "HttpService",
    "ModelManager",
    "RequestShedError",
    "ServiceMetrics",
    "ServiceOverloadedError",
    "build_pipeline_engine",
]
