"""PyTorch + CUDA port of the ConServe reproduction (the JAX package `repro`
is the reference). The serving path — qwen3-0.6b through `ReplicaEngine`,
`EngineServer` and the ConServe scheduler — runs on one NVIDIA H100, with
the two attention kernels of that path written by hand in CUDA C++."""
