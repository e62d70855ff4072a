"""The port's benchmarks (counterparts of ``benchmarks/`` in the JAX
package): each prints CSV rows of ``(name, us_per_call, derived)``."""
