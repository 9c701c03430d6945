"""PyTorch/CUDA port of the horizontally scalable submodular maximizer.

Mirrors :mod:`repro` module by module.  Plain tensor code is PyTorch; the
hot kernels (``kernels/csrc``) are CUDA C++ for Hopper (``sm_90a``), built
with ``nvcc`` at first use.  Entry points run on the card unless the caller
passes ``device="cpu"``, where every kernel takes its plain version.
"""
