"""PyTorch/CUDA port of the AMTHA mapping and evaluation system.

It mirrors the JAX package's module names (``core``, ``online``,
``faults``, ``search``, ``kernels``, ``configs``, ``models``,
``runtime``, ``launch``) and imports nothing from it. Host algorithms
(AMTHA, the lowering, the event loops) run on the host in NumPy; the
batched simulator, the admission scorer and the serving model run on an
NVIDIA GPU through hand-written CUDA kernels, built at first use.
"""
