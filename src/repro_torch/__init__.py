"""PyTorch/CUDA port of the DEFL simulator (the JAX package `repro` is the
reference it is held against).

The package mirrors `repro`'s layout (configs, core, data, models, optim,
federated, kernels) and imports neither `jax` nor anything of `repro`:
the numpy-only modules it needs are kept as copies here. Entry points run
on the CUDA card unless the caller passes device="cpu" (see device.py).
"""
