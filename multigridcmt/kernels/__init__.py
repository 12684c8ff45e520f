"""Hand-written GPU kernels (Pallas, Triton route).

The solver's one implementation of every operation is the ``jax.numpy``
code in ``ops/``, which XLA compiles and fuses. A kernel lives here only
while it beats that code end to end on the card; ``ops/`` stays its
reference.
"""
