"""Host geometry: numpy copies of the JAX package's `ibx.geometry`
modules that the sphere case needs."""
