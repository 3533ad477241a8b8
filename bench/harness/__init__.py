"""The benchmark of the PyTorch and CUDA port: one cell a run (see
``bench/run.py``)."""
