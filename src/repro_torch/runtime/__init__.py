"""Serving runtime: paged KV pool, prefix index, request lifecycle and chaos
injection, the continuous batcher and the disaggregated prefill/decode
engine."""
from .batcher import ContinuousBatcher
from .disagg import DisaggEngine
from .kv_pages import PagePool, PoolStats
from .lifecycle import ChaosConfig, ChaosInjector, FinishReason, Request
from .prefix_cache import PrefixIndex

__all__ = ["ContinuousBatcher", "DisaggEngine", "PagePool", "PoolStats",
           "ChaosConfig", "ChaosInjector", "FinishReason", "Request", "PrefixIndex"]
