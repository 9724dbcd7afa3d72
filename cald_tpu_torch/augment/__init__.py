"""CALD augmentations on fixed-canvas batches (port of ``cald_tpu.augment``)."""
