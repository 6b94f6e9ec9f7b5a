"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf].  Sliding-window attention (1024) everywhere except three
global layers (first/middle/last, per the paper); the mamba path gives
O(1)/token decode — qualifies for long_500k.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    rope_theta=1e4,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    scan_layers=False,          # heterogeneous (global vs SWA layers)
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    dtype="float32",
    remat=False,
    sliding_window=8,
    global_attn_layers=(0,),
    scan_layers=False,
    ssm=SSMConfig(state_dim=8, conv_dim=4, expand=2),
)
