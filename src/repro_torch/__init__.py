"""TeShu on PyTorch and CUDA: the shuffle service, whose cached-plan replay
runs on an NVIDIA Hopper card through hand-written kernels
(:mod:`repro_torch.kernels`).  The host control plane (:mod:`repro_torch.core`)
is numpy, as in the reference package."""
