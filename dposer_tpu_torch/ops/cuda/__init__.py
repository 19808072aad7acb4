"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

``fused_em.get_cuda_em_sampler`` is the reverse-diffusion loop (generation,
masked imputation, the few-step tables, the PF-Euler decode),
``fused_comp.get_cuda_comp_solver`` the completion task's Adam loop,
``fused_ode.get_cuda_ode_sampler`` the RK4 probability-flow-ODE sampler,
``fused_lik.get_cuda_likelihood_fn`` the exact likelihood and
``fused_train.get_cuda_step_fn`` the DSM train step. The kernels and their
plain PyTorch versions are in ``score_net.py`` (K1, K7), ``fused_em.py`` (K2,
K3, K4), ``fused_comp.py`` (K5, K6), ``fused_ode.py`` (K8), ``fused_lik.py``
(K9) and ``fused_train.py`` (K10, K11, K12); ``build.py`` compiles ``csrc/``.
On the card the four sampling loops replay one CUDA graph a call
(``graph_loop.py``).
"""
