from .ops import wkv6, wkv6_plain

__all__ = ["wkv6", "wkv6_plain"]
