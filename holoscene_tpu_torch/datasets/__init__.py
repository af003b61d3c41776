"""Dataset helpers of the port (the loaders themselves are the reference's
jax-free holoscene_tpu.datasets modules)."""
