"""Plain PyTorch and NumPy reference of fastconsensus's semantics.

It imports nothing of the port, of JAX or of the JAX package.  It makes
its own graphs' canonical edge lists and works out again everything the
port derives (padding, counts, thresholds, closures, move gains); the
port's outputs are read only to be judged.
"""
