"""xlstm-350m [ssm] — sLSTM + mLSTM block stack (xLSTM[7:1]).

24L d_model=1024 4H vocab=50304, d_ff=0 (xLSTM blocks carry their own projection
FFN) [arXiv:2405.04517; unverified].  Sub-quadratic: runs long_500k with
O(1)/token recurrent decode state.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_head=256,
    d_ff=0,
    vocab=50304,
    scan_layers=False,          # heterogeneous (sLSTM every 8th block)
    ssm=SSMConfig(slstm_every=8),
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=0,
    vocab=256,
    dtype="float32",
    remat=False,
    scan_layers=False,
    ssm=SSMConfig(slstm_every=2),   # one mLSTM + one sLSTM block
)
