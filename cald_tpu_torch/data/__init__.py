"""Host-side data layer (port of ``cald_tpu.data``): VOC parsing, padded
batching, the prefetching loader, the AL pool state and the synthetic
generators. NumPy only; copied from the JAX package, whose package imports
pull in JAX. Import the modules themselves; this package imports nothing
eagerly."""
