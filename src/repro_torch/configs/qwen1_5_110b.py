"""qwen1.5-110b [dense] — GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 [hf:Qwen/Qwen1.5; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab=256,
    qkv_bias=True,
    dtype="float32",
    remat=False,
)
