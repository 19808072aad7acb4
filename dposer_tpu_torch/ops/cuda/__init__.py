"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

``fused_em.get_cuda_em_sampler`` is the reverse-diffusion loop (generation,
masked imputation, the few-step tables) and ``fused_comp.get_cuda_comp_solver``
the completion task's Adam loop. The kernels and their plain PyTorch versions
are in ``score_net.py`` (K1), ``fused_em.py`` (K2, K3, K4) and
``fused_comp.py`` (K5, K6); ``build.py`` compiles ``csrc/``.
"""
