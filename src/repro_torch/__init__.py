"""PyTorch/CUDA port of the SuperSFL reproduction (the JAX package
``repro`` stays the reference).

Module names follow the JAX package. Parameters are dicts of tensors with
the JAX tree's keys; every entry point takes an explicit ``device`` and
runs on the card unless told ``device="cpu"``. The TPU kernels on the
port's path are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` on first use (``repro_torch.kernels.build``); each wrapper takes
its plain PyTorch version only for CPU tensors.
"""
