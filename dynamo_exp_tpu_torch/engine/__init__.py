from .config import EngineConfig
from .engine import TorchEngine, resolve_attn_impl
from .kv_manager import KvEvent, KvPageManager
from .offload import CopyStream, HostKvPool
from .scheduler import Scheduler, Sequence

__all__ = [
    "EngineConfig",
    "TorchEngine",
    "resolve_attn_impl",
    "KvEvent",
    "KvPageManager",
    "HostKvPool",
    "CopyStream",
    "Scheduler",
    "Sequence",
]
