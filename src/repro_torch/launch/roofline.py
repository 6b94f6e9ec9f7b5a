"""Roofline analysis of the dry run's counts, on the NVIDIA H100.

Counterpart of ``repro.launch.roofline``.  Three terms per (arch x shape x
mesh) cell, all in seconds:

    compute_s    = FLOPs_per_rank / PEAK_FLOPS              (989 TFLOP/s bf16)
    memory_s     = HBM_bytes_per_rank / HBM_BW              (3.35 TB/s)
    collective_s = ici_wire_bytes / ICI_BW + dcn_wire_bytes / DCN_BW

The counts come from :class:`repro_torch.launch.op_analysis.OpCounter`
(one step run on a rank, loops unrolled as they run), not from compiled
HLO: they are per rank already.  On this card the terms mean:

* ``compute_s``: the counted matmul FLOPs (and each kernel's own) at the
  tensor cores' dense bf16 peak; float32 matmuls would run slower, so it
  is a floor.
* ``memory_s``: eager torch's traffic, each operation reading its inputs
  and writing its outputs in HBM (L2 hits counted as HBM traffic, so it
  overstates what the card moves where an operation's inputs stay in its
  50 MB L2); ``memory_s_kernel`` leaves out the plain blocked attention's
  traffic, which the flash kernel keeps on chip.
* ``collective_s``: ``ici`` is NVLink 4 inside one node of 8 GPUs, ``dcn``
  the network between nodes; a group of ranks that straddles a multiple of
  :data:`NVLINK_DOMAIN` counts as ``dcn`` (the reference's pod of 256 chips
  is its ``ici`` domain).

``row()`` keeps the reference's keys (``ici_gb``, ``dcn_gb``,
``memory_s_kernel``, ``mfu``, ...), so that ``report`` renders rows of
either package.  The constants are the card's; the TPU constants that
``core/topology.py`` keeps for the shuffle model are not used here.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM 80GB HBM3 data-sheet figures, per GPU
PEAK_FLOPS = 989e12          # bf16 dense on the tensor cores
HBM_BW = 3.35e12             # HBM3
ICI_BW = 450e9               # NVLink 4 inside an 8-GPU node, one direction
DCN_BW = 50e9                # between nodes: one 400 Gb/s NIC a GPU
NVLINK_DOMAIN = 8            # ranks one NVLink domain joins (the reference's
#                              POD_SIZE, 256, is a TPU pod)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float
    dcn_bytes_per_chip: float
    model_flops: float             # 6*N*D (train) / 2*N*D (serve), global
    collective_count: int = 0
    per_chip_hbm_gb: float = 0.0   # argument + the step's peak, a rank
    flash_bytes_per_chip: float = 0.0  # the plain blocked attention's
    #                                    traffic, which the flash kernel
    #                                    keeps on chip

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def memory_s_kernel(self) -> float:
        """Memory term with the flash kernel: the plain blocked attention's
        traffic (logits, the online-softmax state) stays on chip."""
        return max(0.0, self.hbm_bytes_per_chip
                   - self.flash_bytes_per_chip) / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.ici_bytes_per_chip / ICI_BW + self.dcn_bytes_per_chip / DCN_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-bound step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_ratio(self) -> float:
        """useful (model) FLOPs / counted FLOPs: remat and redundancy."""
        counted = self.flops_per_chip * self.chips
        return self.model_flops / counted if counted else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-bound step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_s_kernel": self.memory_s_kernel,
            "collective_s": self.collective_s,
            "ici_gb": self.ici_bytes_per_chip / 1e9,
            "dcn_gb": self.dcn_bytes_per_chip / 1e9,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "model_flops_ratio": self.model_flops_ratio,
            "mfu": self.mfu,
            "hbm_gb": self.per_chip_hbm_gb,
            "collectives": self.collective_count,
        }


def model_flops_for(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (D = tokens/step)."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch            # decode: one token per sequence
    return 2.0 * n * tokens


def analyze(counts, *, arch: str, shape, mesh, cfg) -> Roofline:
    """The roofline of one cell from its :class:`~repro_torch.launch.
    op_analysis.OpCounter` ``counts`` (a rank's step), over ``mesh``
    (anything with a ``shape`` dict of axis sizes)."""
    chips = 1
    for v in mesh.shape.values():
        chips *= v
    return Roofline(
        arch=arch, shape=shape.name,
        mesh="x".join(str(v) for v in mesh.shape.values()),
        chips=chips, flops_per_chip=counts.flops,
        hbm_bytes_per_chip=counts.hbm_bytes,
        ici_bytes_per_chip=counts.ici_bytes,
        dcn_bytes_per_chip=counts.dcn_bytes,
        model_flops=model_flops_for(cfg, shape),
        collective_count=int(counts.collective_count),
        per_chip_hbm_gb=counts.memory["total_gb"],
        flash_bytes_per_chip=counts.flash_bytes)
