"""Microbenchmarks of the port's kernels on the card (ports of the TPU
package's ``benchmarks/mxu_micro.py`` and ``benchmarks/ilp_probe.py``), on
kernel K14 ``chain_link``:

    python -m dposer_tpu_torch.benchmarks.mxu_micro [--device cpu] [--steps N]
    python -m dposer_tpu_torch.benchmarks.ilp_probe [--device cpu] [--steps N]
"""
