"""Model stacks and layers (dense decoder-only subset)."""
from . import layers, modules, transformer
from .convert import from_jax_params
from .transformer import DecoderLM, build_model

__all__ = ["layers", "modules", "transformer", "DecoderLM", "build_model",
           "from_jax_params"]
