"""Hand-written Hopper kernels and their plain-torch versions.

``ref`` holds the plain versions (the CPU path and the allclose oracle),
``gk_step`` the wrappers around the CUDA kernels of ``csrc/gk_step.cu``,
``ops`` the half-step compositions the operators call, ``_build`` the
``nvcc`` build.
"""
