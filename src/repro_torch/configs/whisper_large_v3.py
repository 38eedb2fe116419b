"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed.
[arXiv:2212.04356]: 32 enc + 32 dec layers, d=1280, 20 heads (MHA),
d_ff=5120, vocab=51866 (padded to 51968 for TP divisibility)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    model_kind="encdec",
    n_layers=32,
    enc_layers=32,
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    norm="layernorm",
    mlp="gelu",
    # the reference's layout (pure data parallel); the port's single-device
    # path does not read it
    layout="dp",
)
