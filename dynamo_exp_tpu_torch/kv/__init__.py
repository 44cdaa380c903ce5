"""KV primitives: the radix ``PrefixIndex`` and the G3 persistent page
store ``PersistentKvStore``."""

from .persistent import PersistentKvStore
from .prefix import PrefixIndex

__all__ = ["PersistentKvStore", "PrefixIndex"]
