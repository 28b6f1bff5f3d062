"""Architecture configuration system.

One frozen dataclass describes every architecture in the zoo; families:
``dense`` | ``moe`` | ``ssm`` | ``hybrid`` | ``vlm`` | ``audio``.
Each architecture file in this package instantiates the exact published
config, and ``reduced()`` gives a smoke-test variant (2 layers,
d_model <= 512, <= 4 experts) of the same family.

The port of ``repro.configs.base``, field for field, with the input
shapes (``InputShape``, ``INPUT_SHAPES``) the dry run reads
(``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every: int = 1          # layer i has an MoE FFN iff i % every == every - 1
    d_ff: int | None = None  # per-expert hidden dim (defaults to ArchConfig.d_ff)


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256        # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp (plain MLP)
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope: str = "rope"              # rope | mrope | sincos | learned | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    # hybrid: layer i is attention iff i % attn_period == attn_offset, else SSM.
    attn_period: int = 1
    attn_offset: int = 0
    # encoder-decoder (audio): encoder consumes precomputed frame embeddings.
    enc_dec: bool = False
    num_enc_layers: int = 0
    enc_seq: int = 1500
    # vlm: number of image-patch positions at the start of the sequence.
    vlm_patches: int = 0
    vlm_vision_dim: int = 0
    # long-context variant: sliding-window attention (rolling KV cache).
    sliding_window: int | None = None
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    fsdp: bool = False              # shard params over the data axis too
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def attn_layer(self, i: int) -> bool:
        """Is layer ``i`` an attention layer (vs SSM)?"""
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_period == self.attn_offset
        return True

    def moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every == self.moe.every - 1)

    def supports_long_decode(self) -> bool:
        """long_500k runs for SSM/hybrid natively, others need sliding window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 256, vocab: int = 512) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests."""
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads if cfg.head_dim == 0 else max(16, min(64, cfg.head_dim)),
        d_ff=d_model * 2,
        vocab=vocab,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        fsdp=False,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k), d_ff=d_model
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=32
        )
    if cfg.family == "hybrid":
        kw["num_layers"] = max(layers, cfg.attn_period)  # keep >=1 attention layer
        kw["attn_period"] = max(2, min(cfg.attn_period, kw["num_layers"]))
        kw["attn_offset"] = min(cfg.attn_offset, kw["attn_period"] - 1)
    if cfg.enc_dec:
        kw["num_enc_layers"] = 2
        kw["enc_seq"] = 64
    if cfg.vlm_patches:
        kw["vlm_patches"] = 16
        kw["vlm_vision_dim"] = 128
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 64
    return cfg.replace(**kw)
