"""PyTorch/CUDA port of ``repro`` (see README, "PyTorch/CUDA port")."""
