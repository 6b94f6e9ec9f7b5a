"""pixtral-12b [vlm] — Pixtral ViT frontend (stub) + Mistral-NeMo-12B backbone.

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].  The vision frontend supplies
precomputed patch embeddings via ``input_specs()`` (modality="vlm").
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="dense",
    modality="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e9,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke",
    family="dense",
    modality="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    rope_theta=1e4,
    dtype="float32",
    remat=False,
)
