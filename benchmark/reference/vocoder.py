"""The unit HiFi-GAN V1 generator (speech-resynthesis `CodeGenerator`, as
Parrot-TTS ships it in `utils/vocoder/models.py`) for one utterance.

Weight norm is folded here, w = g v / ||v|| per output channel. The
embedding of the codes and the speaker feeds conv_pre; each upsample
stage is leaky ReLU(0.1), ConvTranspose1d, then the mean of its
ResBlock1s (pairs of dilated and plain convs, each after a leaky ReLU,
with a residual add); then leaky ReLU(0.01), conv_post and tanh.

`dtype` is the configuration's compute type. float32 computes it plain.
bfloat16 keeps the configuration's stated rounding points, those of the
JAX package's bf16 generator: the embedding and every weight and bias
rounded to bf16; each conv sums in float32 and rounds its sum to bf16,
then adds its bias in bf16; a leaky ReLU multiplies by bf16(slope) and
rounds once; the residual adds, the mean of the resblocks (sum, then
/ count) and tanh in bf16. A stage that the configuration runs as one
fused MRF ("fused_mrf", ResBlock1, fewer than 128 channels: the JAX
package's fused route) has that route's rounding points: each conv sums
in float32 from its bias and rounds once, the resblocks are summed in
float32 and the sum times 1 / count is rounded. Every conv here is an
IEEE float32 conv of the bf16 values. float8_e4m3fn (a control, not a
configuration's type) keeps the same rounding points, each value rounded
to e4m3 under its tensor's own scale (absmax / 448), the arithmetic
between them in float32.

`cfg` is the configuration file's "vocoder" object; `sd` the state dict
under the reference's keys (weight_g / weight_v / bias), on the device
the reference runs on.
"""

import torch
import torch.nn.functional as F


def fold(sd: dict) -> dict:
    """Every weight_g / weight_v pair as one weight."""
    out = {}
    for key, val in sd.items():
        if key.endswith(".weight_g"):
            p = key[: -len("_g")]
            v = sd[p + "_v"]
            norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True)
            out[p] = val * v / norm.sqrt()
        elif not key.endswith(".weight_v"):
            out[key] = val
    return out


class _Net:
    def __init__(self, w: dict, dtype: torch.dtype):
        self.w, self.dtype = w, dtype

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to dtype (a no-op on a tensor of that type)."""
        if self.dtype == torch.float8_e4m3fn:
            scale = x.float().abs().amax().clamp_min(1e-30) / 448.0
            return (x.float() / scale).to(self.dtype).float() * scale
        return x.to(self.dtype)

    def conv(self, x, name, *, padding, dilation=1, transpose=False,
             stride=1, fused=False):
        """x (1, C, T) in dtype; float32 sums of dtype values, rounded,
        then the bias added in dtype (fused: the sums start from the
        bias, rounded once)."""
        w = self.r(self.w[name + ".weight"]).float()
        b = self.r(self.w[name + ".bias"])
        if transpose:
            y = F.conv_transpose1d(x.float(), w, stride=stride,
                                   padding=padding)
        else:
            y = F.conv1d(x.float(), w, b.float() if fused else None,
                         padding=padding, dilation=dilation)
        return self.r(y) if fused else self.r(self.r(y) + b[None, :, None])

    def leaky(self, x, slope):
        s = float(self.r(torch.tensor(slope)))
        return torch.where(x >= 0, x, self.r(x * s))


def generate(sd: dict, cfg: dict, codes, speaker: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Waveform (len(codes) * prod(upsample_rates),) in float32."""
    net = _Net(fold(sd), dtype)
    w = net.w
    dev = w["dict.weight"].device
    ids = torch.as_tensor(codes, dtype=torch.int64, device=dev)
    x = w["dict.weight"][ids]
    if cfg.get("multispkr"):
        x = torch.cat([x, w["spkr.weight"][speaker].expand_as(x)], dim=-1)
    x = net.r(x.t()[None])
    x = net.conv(x, "conv_pre", padding=3)
    kernels = cfg["resblock_kernel_sizes"]
    dilations = cfg["resblock_dilation_sizes"]
    nk = len(kernels)
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                   cfg["upsample_kernel_sizes"])):
        fused = (cfg.get("fused_mrf", False) and cfg.get("resblock") == "1"
                 and cfg["upsample_initial_channel"] // 2 ** (i + 1) < 128)
        x = net.leaky(x, 0.1)
        x = net.conv(x, f"ups.{i}", padding=(k - u) // 2, transpose=True,
                     stride=u)
        acc = None
        for j, (rk, rd) in enumerate(zip(kernels, dilations)):
            p, xs = f"resblocks.{i * nk + j}.", x
            for m, d in enumerate(rd):
                xt = net.conv(net.leaky(xs, 0.1), p + f"convs1.{m}",
                              padding=(rk * d - d) // 2, dilation=d,
                              fused=fused)
                xt = net.conv(net.leaky(xt, 0.1), p + f"convs2.{m}",
                              padding=(rk - 1) // 2, fused=fused)
                xs = net.r(xt + xs)
            if fused:
                xs = xs.float()
            acc = xs if acc is None else acc + xs if fused else net.r(acc + xs)
        x = net.r(acc * (1.0 / nk)) if fused else net.r(acc / nk)
    x = net.conv(net.leaky(x, 0.01), "conv_post", padding=3)
    return net.r(torch.tanh(x))[0, 0].float()
