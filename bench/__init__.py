"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`run.py` runs one cell of `BENCHMARK.json`: a model configuration from
`configs/` under a traffic mix from `traffic/`, with the per-layer metrics
read by the readers in `metrics/` and the outputs judged against the plain
references in `reference/`. Everything that measures (traffic generation,
percentiles, operation and byte counts, peaks, the correctness comparison)
lives here, so that a change to the program cannot move the yardstick.
"""
