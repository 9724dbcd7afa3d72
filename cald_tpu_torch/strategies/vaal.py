"""VAAL: variational adversarial active learning (port of
``cald_tpu/strategies/vaal.py``; reference vaal_train.py, vaal/vaal_helper.py).

After (or alongside) task training each cycle: train a VAE on 256x256 resized
images from both pools plus a discriminator that predicts labeled-vs-unlabeled
from the latent mean; select the budget images the discriminator is most
confident are UNLABELED (vaal_helper.py:186-216).

Training losses per step (vaal_train.py:99-148):
  VAE:  vae_loss(labeled) + vae_loss(unlabeled)
        + adv_weight * BCE(D(mu_l), 1) + adv_weight * BCE(D(mu_u), 1)
        (the generator wants BOTH pools to look labeled)
  D:    BCE(D(mu_l), 1) + BCE(D(mu_u), 0)

Under multi-process data parallelism both steps are those of the global
batch, as the JAX package's ``place`` makes them: the KLD is a raw sum over
the global batch (each rank's sum weighted by the rank count before the
gradient average), the MSE and BCE terms are means over it (the ranks'
means averaged).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from cald_tpu_torch.augment.suite import Draw
from cald_tpu_torch.models.init import lecun_init_
from cald_tpu_torch.models.vae import VAAL_VAE, VAALDiscriminator, vae_loss
from cald_tpu_torch.ops.losses import bce_with_logits
from cald_tpu_torch.parallel import process_count, process_mean, reduce_gradients_

VAAL_IMAGE_SIZE = 256


def resize_for_vaal(images: torch.Tensor, size: int = VAAL_IMAGE_SIZE) -> torch.Tensor:
    """(B, H, W, 3) any size -> (B, size, size, 3), kept in 0..255. Bilinear
    with an antialiasing triangle kernel where it shrinks, as
    ``jax.image.resize(..., "bilinear")``."""
    x = F.interpolate(images.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1)


def _bce_mean(logits: torch.Tensor, target: float) -> torch.Tensor:
    return bce_with_logits(logits, torch.full_like(logits, target)).mean()


class VAALTrainer:
    """Owns the VAE and the discriminator (on ``device``) and their updates.

    Reference sizes: z_dim 256, widths 128..1024, 256x256 inputs
    (vaal_helper.py:20-118); smaller values keep CPU tests fast. The VAE is
    initialised from ``seed`` and the discriminator from ``seed + 1``
    (Flax's initial distributions, the port's own draws).

    ``optimizers(vae, disc)`` returns (vae optimizer, its scheduler or None,
    discriminator optimizer, its scheduler or None): the driver's are the
    reference's SGD(lr/10) / SGD(lr) on the warmup + multistep schedule
    (vaal_train.py:221-238). The VAE loss's beta and the adversarial weight
    are the reference's 1.
    """

    def __init__(self, optimizers: Callable, *, z_dim: int = 256, base_width: int = 128,
                 image_size: int = VAAL_IMAGE_SIZE, seed: int = 0, device="cpu"):
        self.vae = VAAL_VAE(z_dim=z_dim, base_width=base_width, start_hw=image_size // 32)
        self.disc = VAALDiscriminator(z_dim=z_dim)
        lecun_init_(self.vae, seed)
        lecun_init_(self.disc, seed + 1)
        self.vae.to(device)
        self.disc.to(device)
        self.z_dim = z_dim
        self.image_size = image_size
        self.vae_opt, self.vae_sched, self.d_opt, self.d_sched = optimizers(self.vae, self.disc)

    def train_step(self, labeled_images: torch.Tensor, unlabeled_images: torch.Tensor,
                   draw: Draw) -> tuple[torch.Tensor, torch.Tensor]:
        """One VAE step, then one discriminator step on the means the
        updated VAE gives (vaal_train.py:125-128). ``draw(i, (B, z_dim),
        kind="normal")`` supplies the reparameterisation normals of the
        labeled (i = 0) and unlabeled (i = 1) batch; both passes use them.
        Returns the two losses as detached device scalars (the global
        batch's under data parallelism)."""
        lab = resize_for_vaal(labeled_images, self.image_size)
        unlab = resize_for_vaal(unlabeled_images, self.image_size)
        eps_l = draw(0, (lab.shape[0], self.z_dim), kind="normal").to(lab.device)
        eps_u = draw(1, (unlab.shape[0], self.z_dim), kind="normal").to(lab.device)

        rl, _, mu_l, lv_l = self.vae(lab, eps_l)
        ru, _, mu_u, lv_u = self.vae(unlab, eps_u)
        # ``beta = ranks``: the averaged gradient is that of the global KLD sum
        n = process_count()
        vloss = (vae_loss(rl, lab, mu_l, lv_l, n) + vae_loss(ru, unlab, mu_u, lv_u, n)
                 + _bce_mean(self.disc(mu_l), 1.0) + _bce_mean(self.disc(mu_u), 1.0))
        self.vae_opt.zero_grad(set_to_none=True)
        vloss.backward()
        reduce_gradients_(self.vae_opt)
        self.vae_opt.step()
        if self.vae_sched is not None:
            self.vae_sched.step()

        # the means do not depend on the normals: the encoder alone gives them
        with torch.no_grad():
            mu_l2, mu_u2 = self.vae.encode(lab)[0], self.vae.encode(unlab)[0]
        dloss = _bce_mean(self.disc(mu_l2), 1.0) + _bce_mean(self.disc(mu_u2), 0.0)
        self.d_opt.zero_grad(set_to_none=True)
        dloss.backward()
        reduce_gradients_(self.d_opt)
        self.d_opt.step()
        if self.d_sched is not None:
            self.d_sched.step()
        return tuple(process_mean(torch.stack([vloss.detach(), dloss.detach()])).unbind())

    @torch.inference_mode()
    def unlabeled_scores(self, images: torch.Tensor) -> np.ndarray:
        """-sigmoid(D(mu)): higher = more unlabeled-looking
        (vaal_helper.py:186-216 picks the top of -preds). The JAX package
        draws a key per batch that reaches only z; the scores read mu, so
        nothing is drawn here."""
        mu = self.vae.encode(resize_for_vaal(images, self.image_size))[0]
        return -torch.sigmoid(self.disc(mu)).double().cpu().numpy()


def vaal_select(scores: np.ndarray, budget: int) -> np.ndarray:
    """Top-budget by score (scores already negated discriminator outputs)."""
    return np.argsort(-scores, kind="stable")[:budget]
