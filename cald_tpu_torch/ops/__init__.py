"""Geometry and detection ops on fixed-shape tensors (port of ``cald_tpu.ops``).

Variable-count box sets are padded tensors plus validity masks, as in the JAX
package.
"""
