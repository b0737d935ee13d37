"""Model stacks and layers."""
from . import layers, modules, transformer, xlstm
from .convert import from_jax_params
from .transformer import DecoderLM, EncDecLM, build_model

__all__ = ["layers", "modules", "transformer", "xlstm", "DecoderLM", "EncDecLM",
           "build_model", "from_jax_params"]
