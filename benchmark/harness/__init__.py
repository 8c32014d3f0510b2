"""The benchmark's own code: traffic generation, seeded weights, the cells'
drivers, tracing and the comparison that decides ``correct``. It imports
the port (``sparsebev_tpu_torch``) only inside the drivers, and never JAX or
the JAX package."""
