"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel's CUDA source lives under ``csrc/`` and is compiled by
``build.py`` at first use; importing this package builds nothing."""
