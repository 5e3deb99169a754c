"""Framework-neutral utilities the port's slices need, copied from
ray_tpu/util (the port imports nothing of the JAX package)."""
