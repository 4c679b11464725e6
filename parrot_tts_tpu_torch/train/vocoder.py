"""Vocoder GAN training engine: a discriminator step and a generator step
per batch.

Port of `parrot_tts_tpu/train/vocoder.py` (reference
`utils/vocoder/train.py:33-241`): AdamW (b1 0.8, b2 0.99, weight decay
0.01) under the per-epoch exponential schedule, the LSGAN discriminator
step on the detached generator output, then the generator step with
adversarial + feature-matching + mel-L1 x45 losses. As in the JAX step:

- the generator runs forward once per step. The discriminator step reads
  its output detached; the generator loss is differentiated with respect
  to the generator's parameters alone (`torch.autograd.grad`), with the
  updated discriminators frozen, through the saved generator graph;
- both discriminators run real and fake as one stacked 2B batch, and the
  MSD's spectral-norm vectors advance twice per MSD call: twice in the
  discriminator step, whose update is applied to the discriminators that
  carry the advanced vectors, and twice more in the generator step on the
  updated discriminators. Four advances per step, kept in the buffers;
- AdamW is `torch.optim.AdamW(fused=True)`, one optimizer for the
  generator and one for both discriminators, each with the learning rate
  of the schedule at the count of updates made before this one. optax's
  `adamw` takes lr * wd * p inside the update where torch multiplies p by
  (1 - lr * wd) first: the same maths, rounded differently. optax also
  decays the spectral-norm vectors, which sit in its parameter tree with
  zero gradients; the port keeps them as buffers outside the optimizer,
  and the next power iteration normalises that scale away in either case.

Weight norm stays live (`WNConv.kernel()`), never folded. The step runs
under `exact_numerics(exact)`: by default TF32 convolutions and matmuls
on the card, IEEE float32 with `exact=True`. The state is updated in
place.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from parrot_tts_tpu_torch.core.config import (MelConfig, VocoderModelConfig,
                                              VocoderTrainConfig)
from parrot_tts_tpu_torch.core.device import batch_to_device, exact_numerics
from parrot_tts_tpu_torch.models.vocoder import discriminator as disc
from parrot_tts_tpu_torch.models.vocoder import generator as gen
from parrot_tts_tpu_torch.models.vocoder import losses
from parrot_tts_tpu_torch.ops import stft
from parrot_tts_tpu_torch.train.schedules import exponential_epoch_schedule

BATCH_DTYPES = {"audio": torch.float32, "code": torch.int64,
                "spkr": torch.int64, "mel": torch.float32}


def make_optimizers(g_params, d_params) -> tuple[torch.optim.AdamW,
                                                 torch.optim.AdamW]:
    """(generator optimizer, discriminators' optimizer): optax.adamw(eps
    1e-8, weight_decay 0.01), their moments and counts made at once (zero)
    so that a checkpoint or a converted JAX state loads before the first
    step. `train_step` sets each update's learning rate and betas from its
    VocoderTrainConfig."""
    def adamw(params):
        params = list(params)
        opt = torch.optim.AdamW(params, eps=1e-8, weight_decay=0.01,
                                fused=True)
        for p in params:
            opt.state[p] = {"step": torch.zeros((), dtype=torch.float32,
                                                device=p.device),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        return opt

    return adamw(g_params), adamw(d_params)


def set_hyperparameters(opts, cfg: VocoderTrainConfig, steps_per_epoch: int,
                        count: int) -> None:
    """The learning rate and betas of the update after `count` updates:
    optax evaluates the schedule at the count before the update."""
    lr = exponential_epoch_schedule(cfg.learning_rate, cfg.lr_decay,
                                    steps_per_epoch)(count)
    for opt in opts:
        opt.param_groups[0].update(lr=lr, betas=(cfg.adam_b1, cfg.adam_b2))


@dataclass
class VocoderTrainState:
    """The generator, the two discriminators (their spectral-norm vectors
    as buffers), their AdamW optimizers (`opt_d` over both
    discriminators) and `step`, the updates made so far."""

    gen: gen.CodeGenerator
    mpd: disc.MultiPeriodDiscriminator
    msd: disc.MultiScaleDiscriminator
    opt_g: torch.optim.AdamW
    opt_d: torch.optim.AdamW
    step: int = 0

    def g_params(self) -> dict:
        return dict(self.gen.named_parameters())

    def d_params(self) -> dict:
        return {**{f"mpd.{k}": p for k, p in self.mpd.named_parameters()},
                **{f"msd.{k}": p for k, p in self.msd.named_parameters()}}

    def moments(self) -> dict:
        """AdamW's moments "mu_g", "nu_g", "mu_d", "nu_d", each keyed by
        parameter name (the discriminators' as "mpd.<name>" /
        "msd.<name>"); the optimizers' own tensors."""
        out = {}
        for tag, opt, params in (("g", self.opt_g, self.g_params()),
                                 ("d", self.opt_d, self.d_params())):
            for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                out[f"{m}_{tag}"] = {k: opt.state[p][key]
                                     for k, p in params.items()}
        return out

    def state_dict(self) -> dict:
        """Everything a resumed run needs, for `core/checkpoint.py`."""
        return {"gen": self.gen.state_dict(), "mpd": self.mpd.state_dict(),
                "msd": self.msd.state_dict(), **self.moments(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("gen", "mpd", "msd"):
            getattr(self, name).load_state_dict(sd[name], strict=True)
        with torch.no_grad():
            for name, mine in self.moments().items():
                if mine.keys() != sd[name].keys():
                    raise ValueError(f"checkpoint {name} names differ")
                for k, v in sd[name].items():
                    mine[k].copy_(v)
            self.step = int(sd["step"])
            for opt in (self.opt_g, self.opt_d):
                for st in opt.state.values():
                    st["step"].fill_(self.step)


def _check_trainable(model_cfg: VocoderModelConfig) -> None:
    """Only the float generator with weight norm live trains."""
    if model_cfg.quant != "none":
        raise ValueError(
            f"VocoderModelConfig.quant={model_cfg.quant!r} is a SERVING "
            "config (rounding has a zero gradient, so every quantized conv "
            "would train with zero gradients). Train with quant='none' and "
            "enable quant at synthesis time.")
    if model_cfg.fused_mrf:
        raise ValueError(
            "VocoderModelConfig.fused_mrf=True is a serving config (the "
            "fused kernel runs on folded weights and has no backward). Train "
            "with fused_mrf=False and enable it at synthesis time.")
    if model_cfg.f0:
        raise NotImplementedError(
            "the port does not train f0-conditioned vocoders yet (f0=False)")


def init_state(seed: int, model_cfg: VocoderModelConfig,
               device) -> VocoderTrainState:
    """Seeded generator and discriminators (`generator.init_code_generator`,
    `discriminator.init_mpd` / `init_msd` from one torch.Generator), their
    optimizers with zero moments, step 0."""
    _check_trainable(model_cfg)
    rng = torch.Generator().manual_seed(seed)
    nets = []
    for module, init in ((gen.CodeGenerator(model_cfg),
                          lambda: gen.init_code_generator(model_cfg, rng)),
                         (disc.MultiPeriodDiscriminator(),
                          lambda: disc.init_mpd(rng)),
                         (disc.MultiScaleDiscriminator(),
                          lambda: disc.init_msd(rng))):
        module.load_state_dict(init(), strict=True)
        nets.append(module.to(device).train())
    g, mpd, msd = nets
    return VocoderTrainState(g, mpd, msd, *make_optimizers(
        g.parameters(), [*mpd.parameters(), *msd.parameters()]))


def to_batch(batch: dict, device) -> dict:
    """numpy batch (the loader's keys; `filenames` dropped) -> tensors on
    device, copied from pinned memory without blocking the host."""
    return batch_to_device(batch, BATCH_DTYPES, device)


def loss_mel(y: torch.Tensor, mel_cfg: MelConfig) -> torch.Tensor:
    """Loss mel of (B, T) waveforms; fmax_for_loss is null in the reference
    config (config.json:36), i.e. full-band."""
    return stft.mel_spectrogram(
        y, n_fft=mel_cfg.n_fft, num_mels=mel_cfg.num_mels,
        sampling_rate=mel_cfg.sampling_rate, hop_size=mel_cfg.hop_size,
        win_size=mel_cfg.win_size, fmin=mel_cfg.fmin, fmax=None)


def _disc_dtype(train_cfg: VocoderTrainConfig) -> torch.dtype | None:
    dt = getattr(torch, train_cfg.disc_dtype)
    return None if dt == torch.float32 else dt


@contextlib.contextmanager
def _frozen(*modules):
    """Parameters of modules held as constants (no gradient) inside."""
    params = [p for m in modules for p in m.parameters()]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _apply(opt: torch.optim.AdamW, loss: torch.Tensor) -> None:
    """One AdamW update of opt's parameters from loss's gradients with
    respect to them alone."""
    params = opt.param_groups[0]["params"]
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _detached(fmaps):
    return [[f.detach() for f in fm] for fm in fmaps]


def train_step(state: VocoderTrainState, batch: dict,
               model_cfg: VocoderModelConfig, train_cfg: VocoderTrainConfig,
               mel_cfg: MelConfig, steps_per_epoch: int, *,
               exact: bool = False) -> dict:
    """One GAN step on batch (tensors on the state's device: audio (B, T),
    code (B, Tc), spkr (B,), optionally the ground-truth loss mel). Updates
    state in place; returns the metrics as 0-d tensors (no host sync)."""
    _check_trainable(model_cfg)
    set_hyperparameters((state.opt_g, state.opt_d), train_cfg,
                        steps_per_epoch, state.step)
    ddt = _disc_dtype(train_cfg)
    with exact_numerics(exact):
        y = batch["audio"][:, :, None]
        y_g_hat = state.gen(batch["code"], batch.get("spkr"))
        y_hat = y_g_hat.detach()

        # discriminator step (reference train.py:138-151)
        f_rs, f_gs, _, _ = disc.apply_mpd(state.mpd, y, y_hat, dtype=ddt,
                                          stacked=True)
        s_rs, s_gs, _, _ = disc.apply_msd(state.msd, y, y_hat,
                                          update_sn=True, dtype=ddt,
                                          stacked=True)
        loss_disc_all = (losses.discriminator_loss(f_rs, f_gs)[0]
                         + losses.discriminator_loss(s_rs, s_gs)[0])
        _apply(state.opt_d, loss_disc_all)

        # generator step (reference train.py:153-168) on the updated
        # discriminators, held constant
        mel_real = (batch["mel"] if "mel" in batch
                    else loss_mel(batch["audio"], mel_cfg))
        with _frozen(state.mpd, state.msd):
            mel_l1 = losses.mel_l1_loss(
                mel_real, loss_mel(y_g_hat[:, :, 0], mel_cfg))
            f_rs, f_gs, fmap_f_r, fmap_f_g = disc.apply_mpd(
                state.mpd, y, y_g_hat, dtype=ddt, stacked=True)
            s_rs, s_gs, fmap_s_r, fmap_s_g = disc.apply_msd(
                state.msd, y, y_g_hat, update_sn=True, dtype=ddt,
                stacked=True)
            loss_gen_all = (losses.generator_loss(s_gs)[0]
                            + losses.generator_loss(f_gs)[0]
                            + losses.feature_loss(_detached(fmap_s_r),
                                                  fmap_s_g)
                            + losses.feature_loss(_detached(fmap_f_r),
                                                  fmap_f_g)
                            + mel_l1)
        _apply(state.opt_g, loss_gen_all)
    state.step += 1
    return {"loss_disc_all": loss_disc_all.detach(),
            "loss_gen_all": loss_gen_all.detach(),
            "mel_error": mel_l1.detach() / 45.0}


def val_step(generator: gen.CodeGenerator, batch: dict,
             model_cfg: VocoderModelConfig, mel_cfg: MelConfig
             ) -> torch.Tensor:
    """Validation mel-L1 against batch["mel"] (reference
    train.py:199-228), with the training step's TF32 convolutions on the
    card."""
    with torch.no_grad(), exact_numerics(False):
        y_hat = generator(batch["code"], batch.get("spkr"))
        return torch.mean(torch.abs(batch["mel"]
                                    - loss_mel(y_hat[:, :, 0], mel_cfg)))
