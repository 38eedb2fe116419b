"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887]: 72L, d=8192, 64H (kv=8), d_ff=24576, vocab=65536.
Attention layers use a sliding window at >32k context, so long_500k decode
stays bounded (DESIGN.md §5)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    model_kind="jamba",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    attn_period=8,
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_conv=4,
    long_window=4096,
    # the reference's setting (sequence parallelism off); the port's
    # single-device path does not read it
    use_sp=False,
)
