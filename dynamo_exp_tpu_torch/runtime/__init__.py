from .engine import AsyncEngine, AsyncEngineContext, ResponseStream

__all__ = ["AsyncEngine", "AsyncEngineContext", "ResponseStream"]
