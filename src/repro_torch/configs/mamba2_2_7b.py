"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

64L, d_model 2560, attention-free (d_inner 5120, 80 heads of P=64,
ssm_state 128), vocab 50280.  Mixer-only layers (no FFN), like Mamba.
"""
from .base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab=50280,
    rope="none",
    tie_embeddings=True,
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, conv_width=4, n_groups=1, chunk=256),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    fsdp=True,
    source="arXiv:2405.21060",
)
