"""Host utilities: the metrics registry, the deadline runner, the job
queue and the validator monitor (copies of the JAX package's `utils/`)."""
