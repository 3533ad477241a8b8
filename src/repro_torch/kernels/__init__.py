"""The port's kernels: CUDA C++ sources in ``csrc/`` built at first use
(``build.py``), their launchers and plain PyTorch versions
(``sim_step.py``, ``sched_score.py``), NumPy oracles (``ref.py``) and
the guarded entry points that count launches (``ops.py``)."""
