"""Microbenchmarks of the port's kernels on the card (ports of the TPU
package's ``benchmarks/mxu_micro.py`` and ``benchmarks/ilp_probe.py``), on
kernel K14 ``chain_link``:

    python -m dposer_tpu_torch.benchmarks.mxu_micro [--device cpu] [--steps N]
    python -m dposer_tpu_torch.benchmarks.ilp_probe [--device cpu] [--steps N]

and the train step's layer kernels K10 and K12 against the ring shapes their
design left out (the card only):

    python -m dposer_tpu_torch.benchmarks.train_rings [--rounds 2]
"""
