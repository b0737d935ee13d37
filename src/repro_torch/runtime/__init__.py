"""Serving runtime: paged KV pool, prefix index, request lifecycle and the
continuous batcher."""
from .batcher import ContinuousBatcher
from .kv_pages import PagePool, PoolStats
from .lifecycle import FinishReason, Request
from .prefix_cache import PrefixIndex

__all__ = ["ContinuousBatcher", "PagePool", "PoolStats", "FinishReason",
           "Request", "PrefixIndex"]
