"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), bound with
ctypes, each beside its plain PyTorch version (:mod:`.ref`); :mod:`.ops`
dispatches on the tensor's device."""
