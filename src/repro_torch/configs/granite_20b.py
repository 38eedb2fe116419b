"""granite-20b [dense] — llama-arch code model, MQA (kv=1).
[arXiv:2405.04324]: 52L, d=6144, 48H, kv=1, d_ff=24576, vocab=49152."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    layout="dp",
)
