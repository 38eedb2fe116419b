"""rwkv6-3b [ssm] "Finch" — attention-free, data-dependent decay.
[arXiv:2404.05892]: 32L, d=2560, head_size 64 (40 heads), d_ff=8960,
vocab=65536.  Runs long_500k (state is O(1) in context)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    model_kind="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_size=64,
    scan_chunk=16,
    # the reference's layout (pure data parallel); the port's single-device
    # path does not read it
    layout="dp",
)
