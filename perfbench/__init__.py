"""The benchmark of the PyTorch and CUDA port (``repro_torch``): ``python3 -m perfbench.run``."""
