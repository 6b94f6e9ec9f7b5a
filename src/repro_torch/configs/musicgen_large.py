"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec frontend is a stub; ``input_specs()`` provides frame embeddings
(modality="audio").
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    modality="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab=2048,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="dense",
    modality="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=128,
    dtype="float32",
    remat=False,
)
