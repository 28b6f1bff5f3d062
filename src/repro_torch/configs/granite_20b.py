"""granite-20b [dense] — llama-arch code model [arXiv:2405.04324].

52L, d_model 6144, 48 q-heads with single-KV-head GQA (MQA), d_ff 24576,
vocab 49152.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    act="silu",
    rope="rope",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="arXiv:2405.04324",
)
