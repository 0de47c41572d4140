"""Data and tensor parallelism over ranks (`parallel/mesh.py`, `parallel/tp.py`):
the counterpart of the JAX package's `parallel/` and its (dp, tp) mesh."""
