from .pipeline import Prefetcher, SyntheticLM

__all__ = ["Prefetcher", "SyntheticLM"]
