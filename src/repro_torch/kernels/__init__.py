"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version in :mod:`.ref` and a launch counter on its wrapper.

The shuffle's replay runs PART (:func:`partition_permute`), COMB for +
(:func:`segment_combine`) and the ordered float64 segmented fold
(:func:`segmented_fold`); the LM's serving path runs prefill attention
(:func:`flash_attention`) and decode attention (:func:`decode_attention`),
its MoE blocks the grouped matmul of the expert FFN (:func:`gmm`), and its
xLSTM blocks the sLSTM recurrence (:func:`slstm_scan`).

No kernel has a backward.  On a CUDA tensor, each LM kernel's wrapper
raises when autograd would record the launch (grad mode on and an input
requiring grad), so that no gradient is ever dropped in silence; training
takes the plain paths (``lm.train_loss``).  The shuffle kernels take no
gradients.
"""
from .combine import segment_combine
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .fold import segmented_fold
from .gmm import gmm
from .partition import partition_permute
from .slstm import slstm_scan

SHUFFLE_KERNELS = (partition_permute, segment_combine, segmented_fold)
LM_KERNELS = (flash_attention, decode_attention)
MOE_KERNELS = (gmm,)
SSM_KERNELS = (slstm_scan,)
KERNELS = SHUFFLE_KERNELS + LM_KERNELS + MOE_KERNELS + SSM_KERNELS

__all__ = ["KERNELS", "LM_KERNELS", "MOE_KERNELS", "SHUFFLE_KERNELS",
           "SSM_KERNELS", "decode_attention", "flash_attention", "gmm",
           "partition_permute", "segment_combine", "segmented_fold",
           "slstm_scan"]
