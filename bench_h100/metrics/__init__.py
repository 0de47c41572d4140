"""Per-layer metrics: one reader a quantity, `metrics/<name>.py`.

A metric of BENCHMARK.json is read by `metrics/<its name>.py` or, where
there is no such file, by the file of its name without its last
dot-separated part: `mfu.train` and `mfu.predict` share `mfu.py`. Its unit,
layer and `moves` are BENCHMARK.json's. A reader holds
`read(trace) -> float or None`, where `trace` is a `tracing.Trace` of the
profiled stretch of a `--trace 1` run (its `mix` says the cell's kind). A
reader that finds nothing to read returns None, and the metric is left out
of the result line.
"""
