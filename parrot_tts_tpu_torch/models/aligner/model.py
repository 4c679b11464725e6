"""CTC forced-aligner model: 3x(conv5 + ReLU + BatchNorm) -> BiLSTM ->
linear; port of `parrot_tts_tpu/models/aligner/model.py`.

The module's state-dict keys are the reference `Aligner`'s
(`utils/aligner/model.py:5-61`): `convs.{i}.conv.weight`,
`convs.{i}.bnorm.*`, `rnn.*_l0[_reverse]`, `lin.*`, so the JAX package's
`params_from_torch` reads the port's weights unchanged. Convs run NCW
(cuDNN) with no bias; `nn.BatchNorm1d` keeps the running statistics as
buffers and updates them in a training forward, as the JAX package's
explicit BN state does (batch statistics over every frame of the padded
batch, padded frames included, in JAX and here). The BiLSTM is
`nn.LSTM(bidirectional=True, batch_first=True)` over the whole padded
bucket, unpacked, so the backward direction reads the padding as the JAX
scan does.

The JAX package holds one LSTM bias per direction, b = b_ih + b_hh. The
port keeps torch's two, and `bias_hh_*` does not train (requires_grad is
False): `bias_ih` then takes exactly the JAX bias's gradient and update,
so the optimizer sees the JAX package's parameter set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from parrot_tts_tpu_torch.core.config import AlignerModelConfig
from parrot_tts_tpu_torch.ops import init as init_ops

KERNEL = 5
FROZEN = ("rnn.bias_hh_l0", "rnn.bias_hh_l0_reverse")


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, KERNEL, padding=KERNEL // 2,
                              bias=False)
        self.bnorm = nn.BatchNorm1d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bnorm(F.relu(self.conv(x)))


class Aligner(nn.Module):
    """mel (B, T, n_mels) -> logits (B, T, num_symbols)."""

    def __init__(self, cfg: AlignerModelConfig):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(
            [ConvBN(cin, cfg.conv_dim)
             for cin in (cfg.n_mels, cfg.conv_dim, cfg.conv_dim)])
        self.rnn = nn.LSTM(cfg.conv_dim, cfg.lstm_dim, batch_first=True,
                           bidirectional=True)
        self.lin = nn.Linear(2 * cfg.lstm_dim, cfg.num_symbols)
        for name in FROZEN:
            getattr(self.rnn, name.split(".", 1)[1]).requires_grad_(False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.transpose(1, 2)
        for conv in self.convs:
            x = conv(x)
        x, _ = self.rnn(x.transpose(1, 2))
        return self.lin(x)


def init_aligner(cfg: AlignerModelConfig,
                 gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded state dict with the JAX package's init rules (`init_aligner`:
    torch-default uniform bounds, BN at identity, the summed LSTM bias in
    `bias_ih`, zeros in `bias_hh`)."""
    sd: dict[str, torch.Tensor] = {}
    c, h = cfg.conv_dim, cfg.lstm_dim
    for i, cin in enumerate((cfg.n_mels, c, c)):
        p = f"convs.{i}."
        sd[p + "conv.weight"] = init_ops.kaiming_uniform(
            gen, (c, cin, KERNEL), cin * KERNEL)
        sd[p + "bnorm.weight"] = torch.ones(c)
        sd[p + "bnorm.bias"] = torch.zeros(c)
        sd[p + "bnorm.running_mean"] = torch.zeros(c)
        sd[p + "bnorm.running_var"] = torch.ones(c)
        sd[p + "bnorm.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for sfx in ("", "_reverse"):
        sd[f"rnn.weight_ih_l0{sfx}"] = init_ops.uniform_fan_in(
            gen, (4 * h, c), h)
        sd[f"rnn.weight_hh_l0{sfx}"] = init_ops.uniform_fan_in(
            gen, (4 * h, h), h)
        sd[f"rnn.bias_ih_l0{sfx}"] = (
            init_ops.uniform_fan_in(gen, (4 * h,), h)
            + init_ops.uniform_fan_in(gen, (4 * h,), h))
        sd[f"rnn.bias_hh_l0{sfx}"] = torch.zeros(4 * h)
    sd["lin.weight"] = init_ops.kaiming_uniform(
        gen, (cfg.num_symbols, 2 * h), 2 * h)
    sd["lin.bias"] = init_ops.uniform_fan_in(gen, (cfg.num_symbols,), 2 * h)
    return sd


def apply_aligner(model: Aligner, mel: torch.Tensor, *,
                  train: bool = False) -> torch.Tensor:
    """mel (B, T, n_mels) -> logits (B, T, num_symbols). train=True takes
    batch statistics and updates the BN running statistics in place (the
    JAX package returns them as new state); train=False reads them. The
    module is left in the mode it was in."""
    was = model.training
    model.train(train)
    try:
        return model(mel)
    finally:
        model.train(was)
