"""granite-34b [dense] — llama-arch code model with MQA (kv=1).

88L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e4,
    gated_mlp=False,    # GPT-BigCode-style plain MLP (2 mats) -> 34B total
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,      # keeps the MQA path exercised
    d_head=16,
    d_ff=128,
    vocab=256,
    gated_mlp=False,
    dtype="float32",
    remat=False,
)
