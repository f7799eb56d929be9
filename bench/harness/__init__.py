"""The harness's modules. Only `system`, `drive` and `profile` import the
program (`repro_torch`), and only inside functions, so the spec, the
traffic generator, the statistics, the counts and the references load
without it."""
