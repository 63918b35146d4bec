"""The port's benchmarks: counterparts of the JAX package's ``benchmarks/``,
run as ``python -m repro_torch.benchmarks.<name>``."""
