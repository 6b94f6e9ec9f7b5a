"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version in :mod:`.ref` and a launch counter on its wrapper:
PART (:func:`partition_permute`), COMB for + (:func:`segment_combine`) and
the ordered float64 segmented fold (:func:`segmented_fold`)."""
from .combine import segment_combine
from .fold import segmented_fold
from .partition import partition_permute

KERNELS = (partition_permute, segment_combine, segmented_fold)

__all__ = ["KERNELS", "partition_permute", "segment_combine", "segmented_fold"]
