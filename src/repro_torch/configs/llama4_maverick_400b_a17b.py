"""llama4-maverick-400b-a17b [moe] — 128 experts, top-1, shared expert.
[hf:meta-llama/Llama-4-Maverick]: 48L, d=5120, 40H (kv=8), d_ff=8192/expert,
vocab=202048.  The 128-expert router is the sort-dispatch stress case
(DESIGN.md §5)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    rope_theta=500000.0,
    moe_experts=128,
    moe_top_k=1,
    moe_shared_expert=True,
)
