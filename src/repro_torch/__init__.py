"""PyTorch/CUDA port of the AMTHA mapping and evaluation system.

It mirrors the JAX package's module names (``core``, ``kernels``) and
imports nothing from it. Host algorithms (AMTHA, the lowering, the event
loops) run on the host in NumPy; the batched simulator runs on an NVIDIA
GPU through hand-written CUDA kernels, built at first use.
"""
