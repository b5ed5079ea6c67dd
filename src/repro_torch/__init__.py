"""PyTorch/CUDA port of the SPT reproduction (serving and fine-tuning on
Hopper).

Mirrors the layout of the JAX package ``repro``; imports torch, numpy and
the standard library only.  Kernels are hand-written CUDA C++ for sm_90a,
built at first use (``repro_torch.kernels``)."""
