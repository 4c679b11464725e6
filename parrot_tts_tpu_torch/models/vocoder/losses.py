"""HiFi-GAN LSGAN, feature-matching and mel losses.

Port of `parrot_tts_tpu/models/vocoder/losses.py` (reference
`utils/vocoder/models.py:279-310` and the mel L1 x45 of
`utils/vocoder/train.py:157`). Reductions run in float32 whatever the
discriminator's compute dtype (float64 stays float64).
"""

from __future__ import annotations

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 over all feature maps, x2 (reference models.py:279-285)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(_wide(rl) - _wide(gl)))
    return loss * 2


def discriminator_loss(disc_real, disc_gen):
    """LSGAN D loss: mean((1-D(y))^2) + mean(D(y_hat)^2)
    (reference models.py:288-299). Returns (total, r_losses, g_losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean(torch.square(1.0 - _wide(dr)))
        g = torch.mean(torch.square(_wide(dg)))
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_gen):
    """LSGAN G adversarial loss: mean((1-D(y_hat))^2)
    (reference models.py:302-310). Returns (total, per-discriminator)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_gen:
        l = torch.mean(torch.square(1.0 - _wide(dg)))
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def mel_l1_loss(mel_real: torch.Tensor, mel_gen: torch.Tensor,
                weight: float = 45.0) -> torch.Tensor:
    """L1 mel loss x45 (reference train.py:157)."""
    return torch.mean(torch.abs(mel_real - mel_gen)) * weight
