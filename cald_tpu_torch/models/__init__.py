"""Faster R-CNN ResNet-50-FPN inference (port of ``cald_tpu.models``)."""
