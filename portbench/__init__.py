"""The benchmark of the PyTorch and CUDA port (``dposer_tpu_torch``) on one
H100: ``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``. See README.md."""
