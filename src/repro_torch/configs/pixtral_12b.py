"""pixtral-12b [vlm] — mistral-nemo backbone + ViT frontend (stubbed).
[hf:mistralai/Pixtral-12B-2409]: 40L, d=5120, 32H (kv=8), d_ff=14336,
vocab=131072.  The patch frontend is a stub: input_specs supplies 1024
precomputed patch embeddings prepended to the text stream.  No
``head_dim`` is set, so heads are 5120 / 32 = 160 wide (the reference's
config; the published backbone's are 128)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    rope_theta=1000000.0,
    vision_tokens=1024,
    # the reference's layout (pure data parallel); the port's single-device
    # path does not read it
    layout="dp",
)
