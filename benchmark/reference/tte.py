"""The TTE (Parrot-TTS `modules/parrot.py`, `modules/fft.py`,
`modules/duration.py`) for one utterance, plain float32.

Kept quirks of the reference: the positional "encoding" adds the one row
pe[length] to every position; each block's attention is the bias-free
qkv Linear, then nn.MultiheadAttention's own bias-free in- and
out-projections, then the bias-free wo Linear (no folding); the duration
predictor's second conv pads by 1 whatever its kernel. Durations are
clamp(round(exp(p) - 1), 0), round half to even.

`cfg` is the configuration file's "tte" object; `sd` the unfolded state
dict under the reference's keys, on the device the reference runs on.
"""

import math

import torch
import torch.nn.functional as F


def pos_table(rows: int, d: int, device) -> torch.Tensor:
    """`positionalencoding1d` (modules/fft.py): sin on even, cos on odd
    channels."""
    pe = torch.zeros(rows, d, device=device)
    position = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
          padding: int) -> torch.Tensor:
    """Conv1d over time on x (T, Cin) -> (T', Cout), or on each row of
    x (N, T, Cin)."""
    if x.dim() == 3:
        return F.conv1d(x.transpose(1, 2), w, b, padding=padding
                        ).transpose(1, 2)
    return F.conv1d(x.t()[None], w, b, padding=padding)[0].t()


def _block(sd: dict, p: str, x: torch.Tensor, n_head: int,
           kernel_sizes) -> torch.Tensor:
    """One pre-LN FFT block on x (T, D)."""
    t, d = x.shape
    h = F.layer_norm(x, (d,), sd[p + "attn_norm.weight"],
                     sd[p + "attn_norm.bias"], 1e-5)
    q, k, v = (h @ sd[p + "attention.qkv.weight"].t()).chunk(3, dim=-1)
    wq, wk, wv = sd[p + "attention.mha.in_proj_weight"].chunk(3, dim=0)
    dh = d // n_head

    def heads(y, w):
        return (y @ w.t()).reshape(t, n_head, dh).transpose(0, 1)

    s = heads(q, wq) @ heads(k, wk).transpose(1, 2) / math.sqrt(dh)
    a = (torch.softmax(s, dim=-1) @ heads(v, wv)).transpose(0, 1)
    y = a.reshape(t, d) @ sd[p + "attention.mha.out_proj.weight"].t()
    x = x + y @ sd[p + "attention.wo.weight"].t()
    c = F.layer_norm(x, (d,), sd[p + "conv_norm.weight"],
                     sd[p + "conv_norm.bias"], 1e-5)
    k1, k2 = kernel_sizes
    c = torch.relu(_conv(c, sd[p + "convlayer.conv1.weight"],
                         sd[p + "convlayer.conv1.bias"], (k1 - 1) // 2))
    c = _conv(c, sd[p + "convlayer.conv2.weight"],
              sd[p + "convlayer.conv2.bias"], (k2 - 1) // 2)
    return x + c


def _stack(sd, cfg, name, x):
    for i in range(cfg[name]["n_layer"]):
        x = _block(sd, f"{name}_layers.{i}.", x, cfg[name]["n_head"],
                   cfg["conv_kernel_sizes"])
    return x


def encoder_states(sd: dict, cfg: dict, tokens: list[int]) -> torch.Tensor:
    """The encoder stack's states (S, D), before the speaker."""
    dev = sd["tok_emb.weight"].device
    ids = torch.tensor(tokens, dtype=torch.int64, device=dev)
    pe = pos_table(cfg["max_len"], cfg["d_model"], dev)
    x = sd["tok_emb.weight"][ids] + pe[min(len(tokens), cfg["max_len"] - 1)]
    return _stack(sd, cfg, "encoder", x)


def log_durations(sd: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The duration predictor on states x (S, D) -> (S,), or on each row
    of x (N, S, D) -> (N, S)."""
    dp, k = "duration_predictor.", cfg["dur_kernel_size"]
    h = torch.relu(_conv(x, sd[dp + "layers.0.conv.weight"],
                         sd[dp + "layers.0.conv.bias"], (k - 1) // 2))
    h = F.layer_norm(h, h.shape[-1:], sd[dp + "layers.2.weight"],
                     sd[dp + "layers.2.bias"], 1e-5)
    h = torch.relu(_conv(h, sd[dp + "layers.4.conv.weight"],
                         sd[dp + "layers.4.conv.bias"], 1))
    h = F.layer_norm(h, h.shape[-1:], sd[dp + "layers.6.weight"],
                     sd[dp + "layers.6.bias"], 1e-5)
    return h @ sd[dp + "proj.weight"][0] + sd[dp + "proj.bias"][0]


def encode(sd: dict, cfg: dict, tokens: list[int], speaker: int):
    """(encoder states (S, D) with the speaker added, log durations (S,))."""
    x = encoder_states(sd, cfg, tokens)
    if cfg["n_speaker"] > 1:
        x = x + sd["speaker_emb.weight"][speaker]
    return x, log_durations(sd, cfg, x)


def durations(log_dur: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(torch.exp(log_dur) - 1.0), min=0).long()


def decode(sd: dict, cfg: dict, enc: torch.Tensor,
           dur: torch.Tensor) -> torch.Tensor:
    """Logits (sum(dur), codes) of the encoder states regulated by dur."""
    x = torch.repeat_interleave(enc, dur, dim=0)
    pe = pos_table(cfg["max_len"], cfg["d_model"], enc.device)
    x = x + pe[min(x.shape[0], cfg["max_len"] - 1)]
    x = _stack(sd, cfg, "decoder", x)
    return x @ sd["head.weight"].t() + sd["head.bias"]
