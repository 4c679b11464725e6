"""Batched f0 (pitch) estimation: a port of `parrot_tts_tpu/ops/f0.py`,
the counterpart of the reference's `get_yaapt_f0`
(`utils/vocoder/dataset.py:25-41`, pYAAPT with 20 ms frames every 5 ms
and nccf_thresh1 0.25).

A framed normalized cross-correlation (NCCF) pitch track, 0 marking
unvoiced frames (pYAAPT's `samp_values`), or bridged across unvoiced gaps
(`samp_interp`). All frames of a batch go at once: the NCCF numerator of
every lag is one batched rFFT cross-correlation, the denominator energies
come from a cumulative sum, voicing is peak NCCF > nccf_thresh with a
frame-energy floor, and a 3-tap median removes isolated octave glitches.
The signal is zero-padded by half a frame at both ends and the result is
(B, 1, n_frames), as in the reference function.

The FFT is cuFFT on the card and pocketfft on the CPU; they round
differently from each other and from the JAX package, and voicing is a
threshold, so tracks agree with the JAX package to a tolerance, not bit
for bit. `f0_for_codes` keeps the JAX package's hop ratio, which mixes
sample-rate units off 16 kHz, so that the two packages agree.
"""

from __future__ import annotations

import numpy as np
import torch

from parrot_tts_tpu_torch.core.device import resolve_device

__all__ = ["estimate_f0", "f0_to_code_rate", "f0_for_codes", "f0_hop"]


def _n_frames(n_padded: int, win: int, lag_max: int, hop: int) -> int:
    """Number of full frames (each needs win + lag_max samples)."""
    need = win + lag_max
    if n_padded < need:
        return 1
    return 1 + (n_padded - need) // hop


def f0_hop(rate: int = 16000, frame_space_ms: float = 5.0, **_) -> int:
    """Samples between f0 frames (80 at the defaults)."""
    return int(rate * frame_space_ms / 1000.0)


def estimate_f0(audio, *, device=None, rate: int = 16000,
                frame_length_ms: float = 20.0, frame_space_ms: float = 5.0,
                f0_min: float = 60.0, f0_max: float = 400.0,
                nccf_thresh: float = 0.25,
                interp: bool = False) -> torch.Tensor:
    """audio: (B, N) waveform in [-1, 1] (numpy or a tensor). Returns the
    (B, 1, F) float32 pitch in Hz on `device` (default: the CUDA card;
    raises without one unless device="cpu"): 0 where unvoiced
    (interp=False) or linearly bridged across unvoiced gaps (interp=True).
    Defaults are the reference call site's; pYAAPT's search band 60-400
    Hz."""
    device = resolve_device(device)
    x = torch.as_tensor(audio).to(device, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"audio must be (B, N), got {tuple(x.shape)}")
    n = x.shape[1]
    win = int(rate * frame_length_ms / 1000.0)          # 320 at 16 kHz
    hop = f0_hop(rate, frame_space_ms)                  # 80
    lag_min = max(2, int(rate / f0_max))                # 40
    lag_max = int(np.ceil(rate / f0_min))               # 267
    pad = win // 2
    n_frames = _n_frames(n + 2 * pad, win, lag_max, hop)
    # tail zero-pad so the last frame's lag window is full
    total = (n_frames - 1) * hop + win + lag_max
    x = torch.nn.functional.pad(x, (pad, pad + max(0, total - (n + 2 * pad))))
    frames = x.unfold(-1, win + lag_max, hop)[:, :n_frames]  # (B, F, W+L)

    # NCCF numerator of every lag at once: num[l] = sum_{t<win} f[t] f[t+l]
    nfft = int(2 ** np.ceil(np.log2(win + lag_max)))     # 1024 at 16 kHz
    fa = torch.fft.rfft(frames[..., :win], n=nfft)
    fb = torch.fft.rfft(frames, n=nfft)
    num = torch.fft.irfft(torch.conj(fa) * fb, n=nfft)[..., : lag_max + 1]

    # denominator energies e[l] = |f[l:l+W]|^2 from prefix sums
    csum = torch.nn.functional.pad(torch.cumsum(frames * frames, dim=-1),
                                   (1, 0))
    lags = torch.arange(lag_max + 1, device=device)
    e_l = csum[..., lags + win] - csum[..., lags]        # (B, F, L+1)
    e0 = e_l[..., :1]
    nccf = num / torch.sqrt(e0 * e_l + 1e-9)

    # the SHORTEST lag that is a local peak within 10% of the frame's max
    # (a periodic frame correlates at every multiple of its period)
    band = nccf[..., lag_min: lag_max + 1]
    best = band.amax(dim=-1, keepdim=True)
    pad_b = torch.nn.functional.pad(band, (1, 1), value=-float("inf"))
    is_peak = (band >= pad_b[..., :-2]) & (band >= pad_b[..., 2:])
    cand = is_peak & (band >= 0.9 * best)
    # argmax returns the first maximum (the first hit, or 0 with none) on
    # the CPU and on CUDA, as jnp.argmax does; it takes no bool tensor
    peak_rel = torch.argmax(cand.to(torch.int32), dim=-1)   # (B, F)
    peak_lag = peak_rel + lag_min
    peak_val = torch.gather(band, -1, peak_rel[..., None])[..., 0]

    # parabolic refinement around the integer-lag peak (sub-sample f0)
    lm1 = torch.gather(nccf, -1,
                       (peak_lag - 1).clamp(min=0)[..., None])[..., 0]
    lp1 = torch.gather(nccf, -1,
                       (peak_lag + 1).clamp(max=lag_max)[..., None])[..., 0]
    denom = lm1 - 2.0 * peak_val + lp1
    shift = torch.where(denom.abs() > 1e-9, 0.5 * (lm1 - lp1) / denom,
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    f0 = rate / (peak_lag.to(torch.float32) + shift)
    # voiced: NCCF peak above threshold AND the frame carries energy
    energy = e0[..., 0] / win
    voiced = (peak_val > nccf_thresh) & (energy > 1e-6)
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))

    # 3-tap median (edge-padded): torch.median of three values is the
    # middle one, as jnp.median is
    f0_pad = torch.cat([f0[:, :1], f0, f0[:, -1:]], dim=1)
    stacked = torch.stack([f0_pad[:, :-2], f0_pad[:, 1:-1], f0_pad[:, 2:]],
                          dim=-1)
    f0 = torch.median(stacked, dim=-1).values
    if interp:
        f0 = _interp_unvoiced(f0)
    return f0[:, None, :]


def _interp_unvoiced(f0: torch.Tensor) -> torch.Tensor:
    """Linearly bridge unvoiced (0) gaps between voiced frames, holding
    the edge values outside the first / last voiced frame (pYAAPT's
    `samp_interp` shape). The last voiced frame at or before each frame is
    a running max of voiced indices, the next one at or after a running
    min from the right; no loop over frames."""
    f = f0.shape[-1]
    voiced = f0 > 0.0
    idx = torch.arange(f, device=f0.device).expand_as(f0)
    left = torch.where(voiced, idx, -1).cummax(dim=-1).values
    right = torch.where(voiced, idx, f).flip(-1).cummin(dim=-1).values.flip(-1)
    have_l, have_r = left >= 0, right <= f - 1
    zero = torch.zeros_like(f0)
    left_val = torch.where(have_l, f0.gather(-1, left.clamp(min=0)), zero)
    right_val = torch.where(have_r, f0.gather(-1, right.clamp(max=f - 1)),
                            zero)
    left_pos, right_pos = left.to(f0.dtype), right.to(f0.dtype)
    pos = idx.to(f0.dtype)
    span = torch.clamp(right_pos - left_pos, min=1.0)
    w = (pos - left_pos) / span
    mid = left_val * (1.0 - w) + right_val * w
    filled = torch.where(have_l & have_r, mid,
                         torch.where(have_l, left_val, right_val))
    return torch.where(voiced, f0, filled)


def f0_to_code_rate(f0: torch.Tensor, code_len: int,
                    frames_per_code: int = 4) -> torch.Tensor:
    """Pool a (B, 1, F) pitch track to the code rate: the mean over the
    VOICED frames of each code frame (0 if none), (B, 1, code_len).
    frames_per_code is the HOP ratio (code hop 320 / f0 hop 80 = 4 at the
    defaults), not floor(F / code_len): the extractor's lookahead trims
    tail frames. The tail is zero-padded (unvoiced) to code_len *
    frames_per_code."""
    b, f = f0.shape[0], f0.shape[-1]
    need = code_len * frames_per_code
    track = (f0[..., :need] if f >= need
             else torch.nn.functional.pad(f0, (0, need - f)))
    track = track.reshape(b, 1, code_len, frames_per_code)
    cnt = (track > 0.0).to(track.dtype).sum(dim=-1)
    s = track.sum(dim=-1)
    return torch.where(cnt > 0, s / cnt.clamp(min=1.0), torch.zeros_like(s))


def f0_for_codes(wavs, code_lens, *, rate: int = 16000, code_hop: int = 320,
                 device=None, **kwargs) -> list[np.ndarray]:
    """Per-utterance code-rate f0 tracks from raw waveforms, for serving an
    f0-conditioned vocoder (the reference takes f0 from each utterance's
    SOURCE audio). Each wav is zero-padded to a power of two (>= 4096) as
    in the JAX package, where it bounds the compiled shapes; the zero tail
    is unvoiced and the pooling trims to code_len frames. Returns a list of
    (code_len,) float32 arrays."""
    per = max(1, code_hop // f0_hop(rate, **kwargs))
    out = []
    for w, cl in zip(wavs, code_lens):
        w = np.asarray(w, np.float32).reshape(-1)
        bucket = 1 << max(12, int(np.ceil(np.log2(max(1, len(w))))))
        padded = np.zeros(bucket, np.float32)
        padded[: len(w)] = w
        track = estimate_f0(padded[None], device=device, rate=rate, **kwargs)
        out.append(f0_to_code_rate(track, int(cl), per)[0, 0].cpu().numpy())
    return out
