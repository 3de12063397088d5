"""The step functions of the JAX package's `train/steps.py` that the port
runs: BST's serving and retrieval steps and the GNNs' forward-only loss.
Training (the gradients, optimizers, the train steps) waits for backward
kernels (ROADMAP A16)."""
