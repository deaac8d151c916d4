"""Hand-written Hopper kernels, their plain PyTorch versions, and the
device-dispatching wrappers (:mod:`repro_torch.kernels.ops`)."""
