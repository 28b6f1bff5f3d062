"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model 4096, 32H (GQA kv=8), per-expert d_ff 6400, vocab 32064,
MoE 16e top-2 on every layer.
"""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    act="silu",
    rope="rope",
    tie_embeddings=False,
    moe=MoESpec(num_experts=16, top_k=2, capacity_factor=1.25, every=1, d_ff=6400),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
