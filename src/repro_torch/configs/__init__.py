"""Per-architecture configs (the twin of ``repro.configs``).

Each module exports ``CONFIG: ArchConfig``; ``get(name)`` resolves ids with
dashes/dots normalized.  Every architecture of the reference is ported: the
dense decoders, the MoE family (llama4), rwkv6 (ssm), jamba (hybrid),
whisper (audio, an encoder-decoder) and pixtral (vlm).
"""
from importlib import import_module

_ALIASES = {
    "whisper-large-v3": "whisper_large_v3",
    "granite-20b": "granite_20b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "granite-34b": "granite_34b",
    "llama3.2-3b": "llama3_2_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "pixtral-12b": "pixtral_12b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_ALIASES)

#: the architectures this package can build (all of the reference's)
PORTED_IDS = ARCH_IDS


def get(name: str):
    mod = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    return import_module(f"repro_torch.configs.{mod}").CONFIG
