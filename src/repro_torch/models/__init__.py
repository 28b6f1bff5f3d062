"""Model zoo: smallnet and the LM zoo's attention-only families (dense,
VLM, audio encoder-decoder), serving path."""
from . import attention, layers, rope, smallnet, transformer
from .transformer import Batch, backbone, decode_step, init_caches, init_lm, prefill

__all__ = [
    "Batch",
    "attention",
    "backbone",
    "decode_step",
    "init_caches",
    "init_lm",
    "layers",
    "prefill",
    "rope",
    "smallnet",
    "transformer",
]
