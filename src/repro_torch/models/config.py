"""Architecture configuration (the twin of ``repro.models.config``).

Exact full-size configs live in ``repro_torch.configs.<arch_id>``; every
config also provides ``reduce()`` (same family, tiny dims) for CPU tests.
The fields are the reference's, unchanged, so that a config compares equal
field by field across the two packages; the sharding and scan fields
(``remat_period``, ``scan_unroll``, ``use_sp``, ``layout``) are carried but
not read by the port's single-device eager path.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = True

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1  # every k-th layer is MoE (jamba: 2); llama4: 1 (all)
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25

    # hybrid (jamba): one attention layer per ``attn_period`` layers
    attn_period: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    long_window: int = 4096  # attention window for >32k contexts (jamba)

    # rwkv
    rwkv_head_size: int = 64

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500  # post-conv-stub audio frames (30 s)

    # vlm (pixtral): patch embeddings prepended by the stub frontend
    vision_tokens: int = 0

    model_kind: str = "decoder"  # decoder | encdec | rwkv | jamba
    vocab_pad_multiple: int = 256
    scan_chunk: int = 512  # time-chunk for SSM/linear-attn block-parallel form
    act_dtype: str = "bfloat16"  # activation/compute dtype; f32 master weights
    remat_period: int = 1  # checkpoint granularity: layers per remat block
    scan_unroll: bool = False  # unroll the layer scan
    use_sp: bool = True  # sequence-parallel activations between blocks
    layout: str = "tp"  # "tp": TP/EP on the model axis; "dp": pure data parallel + ZeRO

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def reduce(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU tests."""
        small = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            d_ff=128,
            vocab=512,
            head_dim=16,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=16 if self.enc_layers else self.enc_seq,
            vision_tokens=8 if self.vision_tokens else 0,
            moe_experts=min(4, self.moe_experts) if self.moe_experts else 0,
            scan_chunk=16,
            long_window=64,
            vocab_pad_multiple=64,
            act_dtype="float32",  # small tests compare against f32 oracles
        )
        if self.family == "hybrid":
            small["attn_period"] = 4
            small["n_layers"] = 8
        if self.family == "ssm":
            small["d_model"] = 64
            small["rwkv_head_size"] = 16
        small.update(overrides)
        return replace(self, **small)


# ---------------------------------------------------------------------------
# shape grid (one entry per input-shape column)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
