"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

``fused_em.get_cuda_em_sampler`` is the reverse-diffusion loop; its kernels
and their plain PyTorch versions are in ``score_net.py`` (K1) and
``fused_em.py`` (K2, K3); ``build.py`` compiles ``csrc/``.
"""
