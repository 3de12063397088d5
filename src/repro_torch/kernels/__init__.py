"""The kernel layer: `ops` dispatches each hot-path op to its CUDA kernel
(tensors on the card) or its plain PyTorch version (`ref`)."""
