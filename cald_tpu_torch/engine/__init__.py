"""Training engine (port of the training part of ``cald_tpu.engine``): SGD
with frozen prefixes, the warmup + multistep schedule, the train step and the
host-side epoch loop. Import the modules themselves; this package imports
nothing eagerly."""
