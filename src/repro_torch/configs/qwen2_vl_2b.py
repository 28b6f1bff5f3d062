"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L, d_model 1536, 12H (GQA kv=2), d_ff 8960, vocab 151936.  The vision
encoder is a stub: input_specs supplies precomputed patch embeddings
(vision_dim 1536) consumed through a linear projector; M-RoPE uses
(t, h, w) position streams.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    act="silu",
    rope="mrope",
    rope_theta=1e6,
    tie_embeddings=True,
    vlm_patches=256,
    vlm_vision_dim=1536,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="arXiv:2409.12191",
)
