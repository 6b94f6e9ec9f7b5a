"""deepseek-v2-236b [moe] — MLA attention + 2 shared + 160 routed experts top-6.

60L d_model=5120 128H d_ff_expert=1536 vocab=102400, MLA kv_lora=512
[arXiv:2405.04434; hf].  Layer 0 keeps a dense FFN (d_ff=12288) per the paper;
MoE dispatch runs through the TeShu shuffle layer (two-level exchange template
across pods — the paper-representative integration).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=12288,                 # layer-0 dense FFN
    vocab=102400,
    rope_theta=1e4,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, num_shared=2, top_k=6, d_ff_expert=1536,
                  capacity_factor=1.25, dispatch="teshu2",
                  router_sample_rate=0.01),
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=256,
    dtype="float32",
    remat=False,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                  nope_head_dim=16, v_head_dim=16),
    moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_ff_expert=32,
                  capacity_factor=2.0, dispatch="teshu2"),
)
