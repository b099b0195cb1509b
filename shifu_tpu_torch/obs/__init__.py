"""Observability pieces of the port (the JAX package's `shifu_tpu/obs/`);
so far only the grammar of `obs.trace_epochs`, which config validation
reads."""
