from . import compression, schedules
from .adamw import AdamW, AdamWState, global_norm

__all__ = ["AdamW", "AdamWState", "global_norm", "compression", "schedules"]
