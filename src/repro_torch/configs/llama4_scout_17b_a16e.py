"""llama4-scout-17b-a16e [moe] — 16 experts, top-1, shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]: 48L, d=5120, 40H (kv=8),
d_ff=8192/expert, vocab=202048.  Early-fusion multimodality is out of the
assigned backbone scope (text path only)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    rope_theta=500000.0,
    moe_experts=16,
    moe_top_k=1,
    moe_shared_expert=True,
)
