from .config import EngineConfig
from .engine import TorchEngine, resolve_attn_impl
from .kv_manager import KvEvent, KvPageManager
from .scheduler import Scheduler, Sequence

__all__ = [
    "EngineConfig",
    "TorchEngine",
    "resolve_attn_impl",
    "KvEvent",
    "KvPageManager",
    "Scheduler",
    "Sequence",
]
