"""Hand-written Hopper kernels and their plain-torch versions.

``ref`` holds the plain versions (the CPU path and the allclose oracle);
``gk_step``, ``reorth``, ``sketch_matvec``, ``sparse_matvec``,
``lowrank_update`` and ``count_sketch`` the wrappers around the CUDA
kernels of ``csrc/<same name>.cu``; ``ops`` the entry points the
operators, sketches, the rank-k update and the sketch-resident state
call; ``_build`` the ``nvcc`` build.
"""
