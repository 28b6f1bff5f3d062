"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679].

32L, d_model 4096, 32H (GQA kv=8), d_ff 16384, vocab 256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab=256_000,
    act="silu",
    rope="rope",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="arXiv:2407.14679",
)
