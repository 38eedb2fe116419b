"""granite-34b [dense] — llama-arch code model, MQA (kv=1).
[arXiv:2405.04324]: 88L, d=6144, 48H, kv=1, d_ff=24576, vocab=49152."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
)
