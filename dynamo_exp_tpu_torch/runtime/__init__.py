from .annotated import Annotated
from .engine import AsyncEngine, AsyncEngineContext, DeadlineExceededError, ResponseStream
from .pipeline import Operator, build_pipeline

__all__ = [
    "Annotated",
    "AsyncEngine",
    "AsyncEngineContext",
    "DeadlineExceededError",
    "Operator",
    "ResponseStream",
    "build_pipeline",
]
