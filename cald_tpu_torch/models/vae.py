"""VAAL networks (port of ``cald_tpu/models/vae.py``; reference
vaal/vaal_helper.py:20-143).

VAE: 5-conv encoder to a (1024, 8, 8) volume, fc mu/logvar with z_dim=256,
mirrored transposed-conv decoder; inputs are 256x256 images in 0..255.
Discriminator: z -> 512 -> 512 -> 1 MLP (logits). Images come and go as
NHWC, the JAX package's layout; the convolutions run on NCHW, and the
encoder's volume is flattened (and the decoder's seed unflattened) in NHWC
order, so the fc layers' rows are the JAX package's. Float32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cald_tpu_torch.models.layers import Conv, Dense, GroupNorm


class VAAL_VAE(nn.Module):
    def __init__(self, z_dim: int = 256, base_width: int = 128, start_hw: int = 8):
        super().__init__()
        b = base_width
        self.start_hw = start_hw
        self.top = 8 * b
        cin = 3
        for i, w in enumerate((b, 2 * b, 4 * b, 8 * b, 8 * b)):
            self.add_module(f"enc{i}", Conv(cin, w, 4, stride=2, padding=1, bias=False))
            self.add_module(f"enc_norm{i}", GroupNorm(w, min(32, w)))
            cin = w
        flat = self.top * start_hw * start_hw
        self.fc_mu = Dense(flat, z_dim)
        self.fc_logvar = Dense(flat, z_dim)
        self.fc_dec = Dense(z_dim, flat)
        cin = self.top
        widths = (8 * b, 4 * b, 2 * b, b, 3)
        for i, w in enumerate(widths):
            # Flax's ConvTranspose (k4 s2 "SAME", no kernel flip) is this on
            # the spatially flipped kernel (convert/from_flax.py)
            self.add_module(f"dec{i}", nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1))
            if i < len(widths) - 1:
                self.add_module(f"dec_norm{i}", GroupNorm(w, min(32, w)))
            cin = w

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        """x (B, S, S, 3) in 0..255; eps (B, z_dim) standard normals.
        Returns (recon (B, S, S, 3), z, mu, logvar)."""
        mu, logvar = self.encode(x)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.decode(z), z, mu, logvar

    def encode(self, x: torch.Tensor):
        y = x.permute(0, 3, 1, 2)
        for i in range(5):
            y = getattr(self, f"enc{i}")(y)
            y = F.leaky_relu(getattr(self, f"enc_norm{i}")(y), 0.2)
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)         # NHWC flatten
        return self.fc_mu(y), self.fc_logvar(y)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        s = self.start_hw
        y = self.fc_dec(z).reshape(z.shape[0], s, s, self.top).permute(0, 3, 1, 2)
        for i in range(5):
            y = getattr(self, f"dec{i}")(y)
            if i < 4:
                y = F.relu(getattr(self, f"dec_norm{i}")(y))
        return y.permute(0, 2, 3, 1)


class VAALDiscriminator(nn.Module):
    def __init__(self, z_dim: int = 256, hidden: int = 512):
        super().__init__()
        self.fc1 = Dense(z_dim, hidden)
        self.fc2 = Dense(hidden, hidden)
        self.out = Dense(hidden, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """Logits (B,); the sigmoid is applied where they are used."""
        y = F.relu(self.fc2(F.relu(self.fc1(z))))
        return self.out(y)[:, 0]


def vae_loss(recon, x, mu, logvar, beta: float = 1.0) -> torch.Tensor:
    """0.1 * MSE + beta * KLD (vaal_helper.py:171-180): MSE is the mean over
    all pixels, KLD the raw batch sum -0.5 sum(1 + logvar - mu^2 - exp(logvar)),
    not normalized, as in the reference."""
    mse = ((recon - x) ** 2).mean()
    kld = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum()
    return 0.1 * mse + beta * kld
