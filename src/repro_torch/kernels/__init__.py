"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``rpca_admm.admm_tail``, ``svt_subspace.subspace_apply``,
``svt_subspace.subspace_apply_factored``, ``lora_matmul.lora_matmul``,
``lora_matmul.gathered_lora_matmul``, ``local_attention.local_attention``,
``ssd_scan.ssd_scan`` and ``soft_threshold.soft_threshold`` launch CUDA
kernels on CUDA tensors and compute their plain versions (``ref``) on CPU
tensors; ``backend`` holds that policy and the build, ``ops`` the
leading-rank wrappers the models call.
"""
