"""Active-learning strategies (port of ``cald_tpu.strategies``)."""
