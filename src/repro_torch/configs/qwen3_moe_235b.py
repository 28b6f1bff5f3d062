"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

94L, d_model 4096, 64H (GQA kv=4, head_dim 128), per-expert d_ff 1536,
vocab 151936, MoE 128e top-8 on every layer.
"""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    act="silu",
    rope="rope",
    rope_theta=1e6,
    tie_embeddings=False,
    moe=MoESpec(num_experts=128, top_k=8, capacity_factor=1.25, every=1, d_ff=1536),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="hf:Qwen/Qwen3-30B-A3B",
)
