"""LL4AL CIFAR classification demo (port of ``cald_tpu.cifar``; reference
ll4al/): CIFAR ResNet-18 + LossNet active learning on the card."""

from cald_tpu_torch.cifar.data import (
    augment_batch,
    augment_draws,
    load_cifar10,
    normalize,
    synthetic_cifar,
)
from cald_tpu_torch.cifar.driver import CifarALConfig, CifarLL4AL, al_cifar_loop
from cald_tpu_torch.cifar.resnet import CifarResNet18

__all__ = [
    "CifarResNet18", "CifarALConfig", "CifarLL4AL", "al_cifar_loop",
    "load_cifar10", "synthetic_cifar", "augment_batch", "augment_draws", "normalize",
]
