"""Hand-written CUDA kernels of the port (K1 flash-decode, K2 flash-prefill),
their plain PyTorch versions, and the dispatch in `ops`."""
