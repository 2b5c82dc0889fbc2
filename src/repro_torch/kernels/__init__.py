"""Hand-written Hopper kernels and their plain-torch versions.

``ref`` holds the plain versions (the CPU path and the allclose oracle);
``gk_step`` and ``sketch_matvec`` the wrappers around the CUDA kernels of
``csrc/<same name>.cu``; ``ops`` the entry points the operators and
sketches call; ``_build`` the ``nvcc`` build.
"""
