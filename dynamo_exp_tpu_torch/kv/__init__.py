"""KV prefix-sharing primitives: the radix ``PrefixIndex``."""

from .prefix import PrefixIndex

__all__ = ["PrefixIndex"]
