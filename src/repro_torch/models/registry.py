"""Model registry (the twin of ``repro.models.registry``): a uniform API over
the reference's four model kinds: the decoder (dense, MoE, and pixtral's
patch-prefixed ``vlm``), encdec (whisper), rwkv (``ssm``) and jamba
(``hybrid``).

``get_model(cfg, device)`` returns a ``Model`` with:

    init(generator, dtype)          -> params (drawn in float32, cast to dtype as drawn)
    init_shapes()                   -> params on the ``meta`` device (shapes, no data)
    forward(params, tokens, frames=, patches=)
                                    -> (logits, aux)  (train / prefill shapes)
    loss_fn(params, batch)          -> scalar          (train shapes)
    init_cache(batch, cache_len)    -> cache           (a full cache, as the reference)
    decode_step(params, cache, tok) -> (logits, cache) (decode shapes)
    make_batch(shape, generator)    -> real tensors
    supports(shape)                 -> (bool, reason)

The device is the card unless the caller names another; with no CUDA device
and none named, ``get_model`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.data.table import resolve_device

from . import jamba as jamba_mod
from . import lm as lm_mod
from . import rwkv6 as rwkv6_mod
from . import whisper as whisper_mod
from .config import ArchConfig, ShapeSpec


@dataclass
class Model:
    cfg: ArchConfig
    mod: Any
    device: torch.device

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.float32):
        return self.mod.init(self.cfg, generator, self.device, dtype)

    def init_shapes(self):
        """The parameter tree as ``meta`` tensors: its shapes and dtypes
        without drawing the weights (a restore's ``like``)."""
        return self.mod.init(self.cfg, torch.Generator(), "meta")

    def forward(self, params, tokens, window: int = 0, remat: bool = True, frames=None, patches=None):
        """``frames`` (encdec: the stub frontend's ``[B, enc_seq, d]``) or
        ``patches`` (vlm: ``[B, Nv, d]`` put in front of the tokens)."""
        kw = {}
        if frames is not None:
            kw["frames"] = frames
        if patches is not None:
            kw["patch_embeds"] = patches
        return self.mod.forward(self.cfg, params, tokens, window=window, remat=remat, **kw)

    def loss_fn(self, params, batch):
        return self.mod.loss_fn(self.cfg, params, batch)

    def init_cache(self, batch: int, cache_len: int):
        return self.mod.init_cache(self.cfg, batch, cache_len, device=self.device)

    def decode_step(self, params, cache, token):
        return self.mod.decode_step(self.cfg, params, cache, token)

    def supports(self, shape: ShapeSpec) -> Tuple[bool, str]:
        # the reference's answer by family
        if shape.name == "long_500k":
            if self.cfg.family in ("ssm", "hybrid"):
                return True, "sub-quadratic (SSM/windowed-attention) path"
            return False, "pure full attention is quadratic at 500k (DESIGN.md §5)"
        return True, ""

    def make_batch(self, shape: ShapeSpec, generator: torch.Generator) -> Dict[str, Any]:
        """Random inputs of ``shape``: a full cache and one token per
        sequence for decode shapes, else ``tokens`` and ``labels``, with
        ``frames [B, enc_seq, d]`` for encdec and, where the config has
        vision tokens, ``patches [B, min(vision_tokens, T // 2), d]`` in
        front of ``T - Nv`` tokens (float32 normal · 0.02, as the
        reference's)."""
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len
        hi = max(2, cfg.vocab - 1)
        if shape.kind == "decode":
            return {
                "cache": self.init_cache(B, T),
                "token": torch.randint(0, hi, (B,), generator=generator, device=self.device),
            }

        def normal(*size):
            return torch.randn(size, generator=generator, device=self.device) * 0.02

        out = {}
        if cfg.model_kind == "encdec":
            out["frames"] = normal(B, cfg.enc_seq, cfg.d_model)
        elif cfg.vision_tokens:
            nv = min(cfg.vision_tokens, T // 2)
            out["patches"] = normal(B, nv, cfg.d_model)
            T -= nv
        out["tokens"] = torch.randint(0, hi, (B, T), generator=generator, device=self.device)
        out["labels"] = torch.randint(0, hi, (B, T), generator=generator, device=self.device)
        return out


_KIND_TO_MOD = {"decoder": lm_mod, "encdec": whisper_mod, "rwkv": rwkv6_mod, "jamba": jamba_mod}


def get_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.model_kind not in _KIND_TO_MOD:
        raise NotImplementedError(f"{cfg.name}: model kind {cfg.model_kind!r} is none of the reference's "
                                  f"{sorted(_KIND_TO_MOD)}")
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run the plain PyTorch path")
    return Model(cfg, _KIND_TO_MOD[cfg.model_kind], dev)


def get_model_by_name(name: str, reduced: bool = False, device=None) -> Model:
    from repro_torch import configs

    cfg = configs.get(name)
    if reduced:
        cfg = cfg.reduce()
    return get_model(cfg, device)
