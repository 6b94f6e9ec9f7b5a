"""qwen3-moe-235b-a22b [moe] — 128 routed experts top-8, no shared experts.

94L d_model=4096 64H (GQA kv=4) d_ff_expert=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B (family); hf].
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, num_shared=0, top_k=8, d_ff_expert=1536,
                  capacity_factor=1.25, dispatch="teshu2",
                  router_sample_rate=0.01),
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab=256,
    dtype="float32",
    remat=False,
    moe=MoEConfig(num_experts=8, num_shared=0, top_k=2, d_ff_expert=32,
                  capacity_factor=2.0, dispatch="teshu2"),
)
