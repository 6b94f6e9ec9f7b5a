"""The port's LM stack: dense decoder blocks whose attention runs through
the hand-written flash and decode kernels (:mod:`repro_torch.kernels`)."""
