"""Design probes of the port: the JAX package's TPU probes that reach a
kernel (`benchmarks/mxu_probe.py`, `benchmarks/sync_probe.py` at the
repository root), on the port's kernels, with the same inputs."""
