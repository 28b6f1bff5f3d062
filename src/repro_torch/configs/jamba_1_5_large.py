"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE [arXiv:2403.19887].

72L, d_model 8192, 64H (GQA kv=8) on the attention layers (1 per 8-layer
block, offset 4), d_ff 24576, vocab 65536, MoE 16e top-2 on every other
layer.  Deviation: SSM layers use our Mamba2/SSD block (Jamba-1.5 ships
Mamba-1); chunked SSD is the TPU-friendly form.
"""
from .base import ArchConfig, MoESpec, SSMSpec

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    act="silu",
    rope="rope",
    tie_embeddings=False,
    attn_period=8,
    attn_offset=4,
    moe=MoESpec(num_experts=16, top_k=2, capacity_factor=1.25, every=2, d_ff=24576),
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, conv_width=4, n_groups=1, chunk=256),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="arXiv:2403.19887",
)
