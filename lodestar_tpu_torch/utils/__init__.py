"""Host utilities: the metrics registry, the deadline runner and the job
queue (copies of the JAX package's `utils/`)."""
