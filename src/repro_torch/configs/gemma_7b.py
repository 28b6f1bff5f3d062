"""gemma-7b [dense] — GeGLU, head_dim 256 [arXiv:2403.08295].

28L, d_model 3072, 16H (kv=16: full MHA on 7b; MQA is the 2b variant),
d_ff 24576, vocab 256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256_000,
    act="gelu",
    rope="rope",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="arXiv:2403.08295",
)
