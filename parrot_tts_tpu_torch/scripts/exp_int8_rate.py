"""The int8 tensor-core rate on the card, and the dynamic int8 conv at the
V1 vocoder's serving sites.

Port of `scripts/exp_pallas_int8.py`. Run from the root of the checkout,
on a CUDA card:

    python -m parrot_tts_tpu_torch.scripts.exp_int8_rate [--reps N]

Part 1, the rate: the GEMM kernel of `ops/qconv.py` (`csrc/int8_gemm.cu`)
at (M, K, N) = (8192, 4096, 4096) in int8 and in bf16, with ms, TOP/s and
the int8/bf16 ratio, beside PyTorch's own calls at the same shape
(`torch._int_mm` where it takes the shape, bf16 `torch.matmul`: yardsticks
the port never calls), and the int8 result held equal to the plain
version.

Part 2, the serving sites: batch 64 of 250 codes through the port's
unfolded V1 sites (the TPU build's folded shapes do not exist here): MRF
convs k3 d1 and k11 d5 at C 256, the stage-2 upsample (256 channels in,
its polyphase conv emitting 4 x 128), and MRF k3 at C 128, 64 and 16 and k7
at C 16. At each: cuDNN's float32 (IEEE, no TF32) and bf16 convs (the
transposed conv for the upsample), the dynamic int8 conv (per-row quantize
and the kernel `csrc/int8_conv.cu`), and the kernel alone on pre-quantized
operands, held bit-identical to its plain version.

Each measurement is one printed line; the first line names the device
(the card's name and power limit from nvidia-smi). Times are device times
from CUDA events. With device="cpu" (the tests, at a tiny size) the
kernels' plain versions run and no time is taken: "not measured".
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from parrot_tts_tpu_torch.core.device import resolve_device
from parrot_tts_tpu_torch.ops import conv as conv_ops
from parrot_tts_tpu_torch.ops import qconv
from parrot_tts_tpu_torch.ops import quant as quant_ops

RATE_SHAPE = (8192, 4096, 4096)      # (M, K, N), the JAX experiment's
# (label, frames per code, Ci, Co, K, dilation, upsample stride or 1) of
# part 2's sites at V1 (channels 512 / 2^(stage+1), hop 5, 20, 80, 320)
SITES = (
    ("MRF k3 d1 C256", 5, 256, 256, 3, 1, 1),
    ("MRF k11 d5 C256", 5, 256, 256, 11, 5, 1),
    ("upsample 2 256->4x128", 5, 256, 128, 8, 1, 4),
    ("MRF k3 d1 C128", 20, 128, 128, 3, 1, 1),
    ("MRF k3 d1 C64", 80, 64, 64, 3, 1, 1),
    ("MRF k3 d1 C16", 320, 16, 16, 3, 1, 1),
    ("MRF k7 d1 C16", 320, 16, 16, 7, 1, 1),
)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _fmt(ms: float | None, ops: float | None = None, unit: str = "") -> str:
    if ms is None:
        return "not measured"
    rate = f" ({ops / ms / 1e9:.1f} {unit})" if ops else ""
    return f"{ms:.4f} ms{rate}"


def _int_mm_takes(device, m: int, k: int, n: int) -> bool:
    """torch._int_mm on CUDA wants M > 16 and K, N multiples of 8."""
    return device.type == "cuda" and m > 16 and k % 8 == 0 and n % 8 == 0


def device_line(device) -> str:
    if device.type != "cuda":
        return f"device {device}: times not measured"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return f"device {smi} (torch.cuda: {torch.cuda.get_device_name(device)})"


def part1(device, shape, reps: int, out) -> dict:
    m, k, n = shape
    timed = device.type == "cuda"
    ops = 2.0 * m * k * n
    rng = np.random.default_rng(0)
    a32 = rng.standard_normal((m, k)).astype(np.float32)
    b32 = rng.standard_normal((k, n)).astype(np.float32)
    aq, bq = (torch.from_numpy(np.clip(np.round(x * 30), -127, 127)
                               .astype(np.int8)).to(device)
              for x in (a32, b32))
    a16, b16 = (torch.from_numpy(x).to(device, torch.bfloat16)
                for x in (a32, b32))
    res = {"shape": shape, "ops": ops}

    def ms(fn):
        if not timed:
            fn()
            return None
        return cuda_ms(fn, reps)

    res["int8_ms"] = ms(lambda: qconv.matmul(aq, bq))
    res["bf16_ms"] = ms(lambda: qconv.matmul(a16, b16))
    res["int_mm_ms"] = (ms(lambda: torch._int_mm(aq, bq))
                        if _int_mm_takes(device, m, k, n) else None)
    res["torch_bf16_ms"] = ms(lambda: torch.matmul(a16, b16))
    res["int8_equal"] = bool(torch.equal(qconv.matmul(aq, bq),
                                         qconv.matmul_reference(aq, bq)))
    tag = f"part 1 (M, K, N) = {shape}:"
    out(f"{tag} kernel int8 {_fmt(res['int8_ms'], ops, 'TOP/s')}")
    out(f"{tag} kernel bf16 {_fmt(res['bf16_ms'], ops, 'TFLOP/s')}")
    ratio = (None if res["int8_ms"] is None
             else res["bf16_ms"] / res["int8_ms"])
    res["ratio"] = ratio
    out(f"{tag} kernel int8/bf16 rate ratio "
        f"{'not measured' if ratio is None else f'{ratio:.3f}x'}")
    out(f"{tag} torch._int_mm "
        + (_fmt(res["int_mm_ms"], ops, "TOP/s")
           if _int_mm_takes(device, m, k, n) else "none (shape not taken)"))
    out(f"{tag} torch.matmul bf16 {_fmt(res['torch_bf16_ms'], ops, 'TFLOP/s')}")
    out(f"{tag} kernel int8 equal to the plain version: {res['int8_equal']}")
    if not res["int8_equal"]:
        raise AssertionError("int8 GEMM differs from its plain version")
    return res


def _site(device, rng, batch, codes, site):
    label, hop, ci, co, k, d, u = site
    t = codes * hop
    x = torch.from_numpy((rng.standard_normal((batch, t, ci)) * 0.3)
                         .astype(np.float32)).to(device)
    if u > 1:   # an upsample: torch ConvTranspose1d weight (Ci, Co, K)
        pad = (k - u) // 2
        w_t = torch.from_numpy((rng.standard_normal((ci, co, k)) * 0.05)
                               .astype(np.float32)).to(device)
        w_packed = conv_ops.polyphase_weights(w_t.permute(2, 0, 1), u,
                                              pad)[0]
        *_, pad_left, q_len = conv_ops._polyphase_plan(k, u, pad)
        pads, dil = (pad_left, q_len - 1 - pad_left), 1

        def float_conv(xf, w):
            return F.conv_transpose1d(xf, w, stride=u, padding=pad)
    else:       # torch Conv1d weight (Co, Ci, K)
        w_t = torch.from_numpy((rng.standard_normal((co, ci, k)) * 0.05)
                               .astype(np.float32)).to(device)
        w_packed = w_t.permute(2, 1, 0)
        pads, dil = (d * (k - 1) // 2,) * 2, d

        def float_conv(xf, w):
            return F.conv1d(xf, w, padding=pads[0], dilation=d)
    return label, t, x, w_t, w_packed, pads, dil, float_conv


def part2(device, batch: int, codes: int, reps: int, out) -> list[dict]:
    timed = device.type == "cuda"
    rng = np.random.default_rng(1)
    rows = []

    def ms(fn):
        if not timed:
            fn()
            return None
        return cuda_ms(fn, reps)

    for site in SITES:
        (label, t, x, w_t, w_packed, pads, dil,
         float_conv) = _site(device, rng, batch, codes, site)
        k_taps, ci, co = w_packed.shape
        qweight = quant_ops.quantize_weight(w_packed)
        xq, sx = quant_ops.quantize_per_row(x)
        scale = sx[:, :, 0] * qweight[1]
        x_ncw = x.transpose(1, 2).contiguous()
        x16, w16 = x_ncw.to(torch.bfloat16), w_t.to(torch.bfloat16)
        t_out = qconv.out_len(t, k_taps, pads, dil)
        ops = 2.0 * batch * t_out * k_taps * ci * co
        row = {"label": label, "B": batch, "T": t, "Ci": ci, "Co": co,
               "K": k_taps, "dilation": dil, "ops": ops}
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            row["cudnn_f32_ms"] = ms(lambda: float_conv(x_ncw, w_t))
        row["cudnn_bf16_ms"] = ms(lambda: float_conv(x16, w16))
        row["dyn_int8_ms"] = ms(lambda: quant_ops.int8_conv_nwc_qweight(
            x, qweight, None, pads=pads, rhs_dilation=dil))
        row["kernel_ms"] = ms(lambda: qconv.int8_conv(
            xq, qweight[0], scale, None, pads=pads, dilation=dil))
        got = qconv.int8_conv(xq, qweight[0], scale, None, pads=pads,
                              dilation=dil)
        want = qconv.int8_conv_reference(xq, qweight[0], scale, None,
                                         pads=pads, dilation=dil)
        row["bit_identical"] = bool(torch.equal(got, want))
        rows.append(row)
        tag = (f"part 2 {label} (B {batch}, T {t}, Ci {ci} -> Co {co}, "
               f"K {k_taps}, d {dil}):")
        for key, name, unit in (
                ("cudnn_f32_ms", "cuDNN float32", "TFLOP/s"),
                ("cudnn_bf16_ms", "cuDNN bf16", "TFLOP/s"),
                ("dyn_int8_ms", "dynamic int8 (quantize + kernel)", "TOP/s"),
                ("kernel_ms", "int8 kernel alone", "TOP/s")):
            out(f"{tag} {name} {_fmt(row[key], ops, unit)}")
        out(f"{tag} int8 kernel bit-identical to its plain version: "
            f"{row['bit_identical']}")
        if not row["bit_identical"]:
            raise AssertionError(f"{label}: int8 conv differs from plain")
        del x, xq, x_ncw, x16, got, want
    return rows


def run(device=None, *, shape=RATE_SHAPE, batch: int = 64, codes: int = 250,
        reps: int = 20, out=print) -> dict:
    """Parts 1 and 2 on `device` (default the card); returns their
    numbers. Raises if a numerics guard fails."""
    device = resolve_device(device)
    out(device_line(device))
    with torch.no_grad():
        return {"part1": part1(device, shape, reps, out),
                "part2": part2(device, batch, codes, reps, out)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=20,
                   help="timed launches per measurement")
    args = p.parse_args(argv)
    run(reps=args.reps, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
