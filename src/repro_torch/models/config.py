"""Model configuration schema shared by all 10 assigned architectures.

A copy of the JAX package's ``models/config.py`` (only the package name
differs).  ``use_pallas`` stays in the schema so that a configuration reads
the same in both packages, but it switches nothing in the port: the port's
attention kernels are chosen by the tensor's device (a CUDA tensor launches
the hand-written kernel, a CPU tensor takes its plain version), and a
caller asks for the plain versions on the card with ``use_kernel=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # "gspmd" = sharding-constraint dispatch (baseline); "teshu" = explicit
    # shard_map all-to-all through the shuffle layer; "teshu2" = two-level exchange
    dispatch: str = "teshu"
    router_sample_rate: float = 0.01      # SAMP rate for dispatch-stat estimation


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """xLSTM / Mamba-style recurrent path."""
    state_dim: int = 16            # hymba per-head SSM state; mLSTM uses d_head
    conv_dim: int = 4
    expand: int = 2
    slstm_every: int = 0           # xLSTM: every k-th block is sLSTM (0 = none)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    modality: str = "text"         # text | vlm | audio (vlm/audio: embeds input stub)
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_head: int = 64
    d_ff: int = 3072
    vocab: int = 32000
    qkv_bias: bool = False
    gated_mlp: bool = True         # SwiGLU (3 mats) vs plain GELU MLP (2 mats)
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    sliding_window: int = 0        # 0 = global attention
    global_attn_layers: Sequence[int] = ()   # hybrid: layers with global attention
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    use_pallas: bool = False       # XLA paths for lowering; Pallas validated in tests
    scan_layers: bool = True

    # ---- derived ------------------------------------------------------------
    @property
    def attn_dims(self) -> tuple[int, int]:
        return self.n_heads * self.d_head, self.n_kv_heads * self.d_head

    def num_params(self) -> int:
        """Analytic parameter count (used for 6·N·D model-FLOPs in §Roofline)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":                    # mLSTM-style blocks
            per = 2 * d * (2 * d) + 2 * d + 4 * 3 * (2 * d) + (2 * d) * d + 2 * d
            return emb + L * per
        if self.mla is not None:
            m = self.mla
            qd = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.nope_head_dim + m.rope_head_dim)
            kvd = d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank * \
                self.n_heads * (m.nope_head_dim + m.v_head_dim)
            attn = qd + kvd + self.n_heads * m.v_head_dim * d
        else:
            qh, kvh = self.attn_dims
            attn = d * (qh + 2 * kvh) + qh * d
        n_mats = 3 if self.gated_mlp else 2
        ffn = n_mats * d * self.d_ff if self.d_ff else 0
        per_layer = attn + ffn
        if self.family == "hybrid" and self.ssm is not None:
            dss = self.d_model * self.ssm.expand
            per_layer += d * 2 * dss + dss * (2 * self.ssm.state_dim + 1) + dss * d
        total = emb + L * per_layer
        if self.moe is not None and self.moe.num_experts:
            e_ffn = 3 * d * self.moe.d_ff_expert
            moe_layers = L - (1 if self.moe.num_shared else 0)  # layer 0 dense (DSv2)
            total += moe_layers * (self.moe.num_experts + self.moe.num_shared) * e_ffn
            total -= moe_layers * ffn                # MoE layers have no dense FFN
        return int(total)

    def num_active_params(self) -> int:
        """Active parameters per token (MoE top-k) — the N in 6·N_active·D."""
        if self.moe is None or not self.moe.num_experts:
            return self.num_params()
        d, L = self.d_model, self.n_layers
        full = self.num_params()
        e_ffn = 3 * d * self.moe.d_ff_expert
        moe_layers = L - (1 if self.moe.num_shared else 0)
        inactive = moe_layers * (self.moe.num_experts - self.moe.top_k) * e_ffn
        return int(full - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
