"""Load the reference's released PyTorch checkpoints into the port's modules.

Port of `parrot_tts_tpu/compat.py`. Three formats exist in the reference:

- TTE: a Lightning .ckpt, state_dict keys prefixed "parrot."
  (`train.py:62,144-151`; the demo notebook downloads
  `epoch=...step=11000.ckpt`);
- vocoder: raw torch.save dicts `g_<step>` ({'generator': sd}) and
  `do_<step>` ({'mpd', 'msd', 'optim_g', 'optim_d', 'steps', 'epoch'})
  (`utils/vocoder/train.py:182-191`, `utils/vocoder/utils.py:48-59`);
- aligner: {'model', 'optim', 'config', 'symbols'}
  (`utils/aligner/trainer.py:77-88`).

The port's modules keep the reference's state-dict keys (weight norm as
`weight_g` / `weight_v`, spectral norm as `weight_orig` / `weight_u` /
`weight_v`), so each loader is `torch.load`, a prefix strip and
`load_state_dict(strict=True)` into a port module on the caller's device
(None: the CUDA card). One name differs: the port's aligner trains one
LSTM bias per direction in `bias_ih` and holds `bias_hh` at 0
(`models/aligner/model.py`), so the reference's two biases are summed
into `bias_ih`.
"""

from __future__ import annotations

from pathlib import Path

import torch

from parrot_tts_tpu_torch.core.config import (AlignerModelConfig,
                                              TTEModelConfig,
                                              VocoderModelConfig)
from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.models.aligner.model import FROZEN, Aligner
from parrot_tts_tpu_torch.models.tte.parrot import Parrot
from parrot_tts_tpu_torch.models.vocoder import discriminator as disc
from parrot_tts_tpu_torch.models.vocoder.generator import CodeGenerator


def _torch_load(path):
    # the reference's files hold Python objects beside the tensors
    # (hyper-parameters, configs, symbol lists)
    return torch.load(path, map_location="cpu", weights_only=False)


def _into(module: torch.nn.Module, sd: dict, device) -> torch.nn.Module:
    module.load_state_dict(sd, strict=True)
    return module.to(resolve_device(device)).eval()


def load_tte_lightning_ckpt(path: str | Path, cfg: TTEModelConfig,
                            device=None) -> tuple[Parrot, dict | None]:
    """Lightning .ckpt (or a plain Parrot state_dict) -> (unfolded
    `Parrot`, the checkpoint's hyper_parameters or None)."""
    ckpt = _torch_load(path)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    stripped = {k[len("parrot."):]: v for k, v in sd.items()
                if k.startswith("parrot.")}
    model = _into(Parrot(cfg), stripped or sd, device)
    return model, ckpt.get("hyper_parameters")


def load_vocoder_generator_ckpt(path: str | Path, cfg: VocoderModelConfig,
                                device=None) -> CodeGenerator:
    """Reference `g_<step>` file -> `CodeGenerator` in weight-norm form."""
    ckpt = _torch_load(path)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    return _into(CodeGenerator(cfg), sd, device)


def load_vocoder_discriminator_ckpt(path: str | Path, device=None):
    """Reference `do_<step>` file -> (MultiPeriodDiscriminator,
    MultiScaleDiscriminator with its spectral-norm vectors, {'steps',
    'epoch'} where present)."""
    ckpt = _torch_load(path)
    meta = {k: ckpt[k] for k in ("steps", "epoch") if k in ckpt}
    return (_into(disc.MultiPeriodDiscriminator(), ckpt["mpd"], device),
            _into(disc.MultiScaleDiscriminator(), ckpt["msd"], device), meta)


def load_aligner_ckpt(path: str | Path, device=None):
    """Reference aligner checkpoint -> (`Aligner`, the checkpoint's config,
    its symbols). The widths are read from the weights; each direction's
    LSTM biases are summed into `bias_ih`, `bias_hh` set to 0."""
    ckpt = _torch_load(path)
    sd = dict(ckpt["model"])
    for hh in FROZEN:
        ih = hh.replace("bias_hh", "bias_ih")
        sd[ih] = sd[ih] + sd[hh]
        sd[hh] = torch.zeros_like(sd[hh])
    cfg = AlignerModelConfig(
        n_mels=sd["convs.0.conv.weight"].shape[1],
        conv_dim=sd["convs.0.conv.weight"].shape[0],
        lstm_dim=sd["rnn.weight_hh_l0"].shape[1],
        num_symbols=sd["lin.weight"].shape[0])
    return _into(Aligner(cfg), sd, device), ckpt.get("config"), \
        ckpt.get("symbols")
