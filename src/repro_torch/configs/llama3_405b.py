"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab=512,
    rope_theta=5e5,
    dtype="float32",
    remat=False,
)
