"""whisper-base [audio] — enc-dec transformer backbone [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model 512, 8H, d_ff 2048, vocab 51865.
The mel-spectrogram + conv frontend is a stub: input_specs provides the
(B, 1500, 512) frame embeddings directly.  Positions are sinusoidal in both
stacks (deviation: whisper's decoder uses learned positions; sincos keeps
params independent of sequence length for the 32k/500k mechanical shapes).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    act="gelu_mlp",
    norm="layernorm",
    rope="sincos",
    tie_embeddings=True,
    enc_dec=True,
    num_enc_layers=6,
    enc_seq=1500,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    source="arXiv:2212.04356",
)
