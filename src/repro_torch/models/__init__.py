"""Model zoo: smallnet and the LM zoo (dense, MoE, SSM, hybrid, VLM and
audio encoder-decoder families), serving path."""
from . import attention, layers, moe, rope, smallnet, ssm, transformer
from .transformer import Batch, backbone, decode_step, init_caches, init_lm, prefill

__all__ = [
    "Batch",
    "attention",
    "backbone",
    "decode_step",
    "init_caches",
    "init_lm",
    "layers",
    "moe",
    "prefill",
    "rope",
    "smallnet",
    "ssm",
    "transformer",
]
