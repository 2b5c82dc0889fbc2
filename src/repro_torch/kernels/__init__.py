"""Hand-written Hopper kernels and their plain-torch versions.

``ref`` holds the plain versions (the CPU path and the allclose oracle);
``gk_step``, ``sketch_matvec``, ``sparse_matvec`` and ``lowrank_update``
the wrappers around the CUDA kernels of ``csrc/<same name>.cu``; ``ops``
the entry points the operators, sketches and the rank-k update call;
``_build`` the ``nvcc`` build.
"""
