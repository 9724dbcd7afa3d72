"""The benchmark's plain reference: a frozen copy of the plain PyTorch code
of ``cald_tpu_torch`` (models, ops, augmentations, CALD scoring, SGD), run
in float32 with TF32 off. It imports nothing of the program: every CUDA
kernel route was taken out (RoIAlign is ``ops/roi_align.py``'s plain
version, the backbone has no fused bottlenecks), and MobileNet is left out.

``layers.Conv`` and ``layers.Dense`` take an optional ``quant`` (a function
applied to the input and the weight before the call), and ``layers.Product``
(every other matrix product, such as attention's) one applied to both
operands, with which the correctness control computes the same model in a
lower precision. A backbone other than ResNet is a file of its own,
``models/backbones/<name>.py``, found by the configuration's name.
"""
