"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L, d_model 2048, 32H (GQA kv=8), d_ff 8192, vocab 128256.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    act="silu",
    rope="rope",
    rope_theta=500_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
