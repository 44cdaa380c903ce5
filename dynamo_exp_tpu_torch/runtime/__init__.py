from .annotated import Annotated
from .engine import AsyncEngine, AsyncEngineContext, ResponseStream
from .pipeline import Operator, build_pipeline

__all__ = [
    "Annotated",
    "AsyncEngine",
    "AsyncEngineContext",
    "Operator",
    "ResponseStream",
    "build_pipeline",
]
