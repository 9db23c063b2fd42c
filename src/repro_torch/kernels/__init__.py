"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``rpca_admm.admm_tail`` and ``svt_subspace.subspace_apply`` launch CUDA
kernels on CUDA tensors and compute their plain versions (``ref``) on CPU
tensors; ``backend`` holds that policy and the build.
"""
