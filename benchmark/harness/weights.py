"""Seeded state dicts, made on the device in a few large draws.

The keys are the reference's: the TTE unfolded (qkv, MultiheadAttention's
in- and out-projections, wo), the vocoder in weight-norm form (weight_g,
weight_v, bias). Each conv or linear weight and bias is U(-1/sqrt(fan_in),
1/sqrt(fan_in)) (torch's default), MultiheadAttention's in-projection
Xavier-uniform, embeddings N(0, 1) (the TTE's padding row 0), LayerNorms
ones and zeros, weight_g the norm of weight_v. One uniform and one normal
draw from a `torch.Generator` on the device fill every leaf; the same
seed and device give the same tensors. The duration predictor's output
weight is then scaled as the configuration assumes; each speaker's row
is picked from a pool of seeded rows as the one that speaks nearest its
assumed frames a character, and the bias set so that round(exp(p) - 1)
averages the configuration's frames a character over a fixed set of
texts (`calibrate`): every seed's speakers speak at the same rates, so
the seed changes the words and the voices and not the amount of work.
"""

import math

import torch


def _tte_leaves(cfg: dict) -> list:
    """(key, shape, init, a) of every TTE leaf: init "u" U(-a, a), "n"
    N(0, 1), "1" ones, "0" zeros."""
    d, nf, nd = cfg["d_model"], cfg["conv_n_filter"], cfg["dur_n_filter"]
    k1, k2 = cfg["conv_kernel_sizes"]
    dk = cfg["dur_kernel_size"]

    def fan(n):
        return 1.0 / math.sqrt(n)

    out = [("tok_emb.weight", (cfg["vocab_size"], d), "n", 0)]
    for name in ("encoder", "decoder"):
        for i in range(cfg[name]["n_layer"]):
            p = f"{name}_layers.{i}."
            out += [
                (p + "attention.qkv.weight", (3 * d, d), "u", fan(d)),
                (p + "attention.mha.in_proj_weight", (3 * d, d), "u",
                 math.sqrt(6.0 / (4 * d))),
                (p + "attention.mha.out_proj.weight", (d, d), "u", fan(d)),
                (p + "attention.wo.weight", (d, d), "u", fan(d)),
                (p + "convlayer.conv1.weight", (nf, d, k1), "u", fan(d * k1)),
                (p + "convlayer.conv1.bias", (nf,), "u", fan(d * k1)),
                (p + "convlayer.conv2.weight", (d, nf, k2), "u", fan(nf * k2)),
                (p + "convlayer.conv2.bias", (d,), "u", fan(nf * k2)),
                (p + "attn_norm.weight", (d,), "1", 0),
                (p + "attn_norm.bias", (d,), "0", 0),
                (p + "conv_norm.weight", (d,), "1", 0),
                (p + "conv_norm.bias", (d,), "0", 0)]
    dp = "duration_predictor."
    out += [(dp + "layers.0.conv.weight", (nd, d, dk), "u", fan(d * dk)),
            (dp + "layers.0.conv.bias", (nd,), "u", fan(d * dk)),
            (dp + "layers.2.weight", (nd,), "1", 0),
            (dp + "layers.2.bias", (nd,), "0", 0),
            (dp + "layers.4.conv.weight", (nd, nd, dk), "u", fan(nd * dk)),
            (dp + "layers.4.conv.bias", (nd,), "u", fan(nd * dk)),
            (dp + "layers.6.weight", (nd,), "1", 0),
            (dp + "layers.6.bias", (nd,), "0", 0),
            (dp + "proj.weight", (1, nd), "u", fan(nd)),
            (dp + "proj.bias", (1,), "u", fan(nd)),
            ("head.weight", (cfg["hubert_codes"], d), "u", fan(d)),
            ("head.bias", (cfg["hubert_codes"],), "u", fan(d))]
    if cfg["n_speaker"] > 1:
        out.append(("speaker_emb.weight", (cfg["n_speaker"], d), "n", 0))
    return out


def _vocoder_leaves(cfg: dict) -> list:
    """Every vocoder leaf as (key, shape, init, a); weight_g is filled
    from its weight_v afterwards ("g")."""
    out = []

    def wn(name, shape, fan_in, n_out):
        a = 1.0 / math.sqrt(fan_in)
        out.extend([(name + ".weight_g", (shape[0],) + (1,) * (len(shape) - 1),
                     "g", 0), (name + ".weight_v", shape, "u", a),
                    (name + ".bias", (n_out,), "u", a)])

    c0 = cfg["upsample_initial_channel"]
    wn("conv_pre", (c0, cfg["model_in_dim"], 7), cfg["model_in_dim"] * 7, c0)
    kernels = cfg["resblock_kernel_sizes"]
    dils = cfg["resblock_dilation_sizes"]
    convs = (("convs1", "convs2") if cfg.get("resblock", "1") == "1"
             else ("convs",))
    ch = c0
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        cin, ch = c0 // 2 ** i, c0 // 2 ** (i + 1)
        wn(f"ups.{i}", (cin, ch, k), cin * k, ch)
        for j, (rk, rd) in enumerate(zip(kernels, dils)):
            for name in convs:
                for m in range(len(rd)):
                    wn(f"resblocks.{i * len(kernels) + j}.{name}.{m}",
                       (ch, ch, rk), ch * rk, ch)
    wn("conv_post", (1, ch, 7), ch * 7, 1)
    out.append(("dict.weight", (cfg["num_embeddings"], cfg["embedding_dim"]),
                "n", 0))
    if cfg.get("multispkr"):
        out.append(("spkr.weight", (cfg["num_speakers"], cfg["embedding_dim"]),
                    "n", 0))
    return out


def _fill(leaves: list, gen: torch.Generator, device) -> dict:
    size = {"u": 0, "n": 0}
    for _, shape, init, _ in leaves:
        if init in size:
            size[init] += math.prod(shape)
    u = torch.rand(size["u"], generator=gen, device=device)
    n = torch.randn(size["n"], generator=gen, device=device)
    at = {"u": 0, "n": 0}
    sd = {}
    for key, shape, init, a in leaves:
        if init in at:
            m = math.prod(shape)
            flat = (u if init == "u" else n)[at[init]: at[init] + m]
            at[init] += m
            sd[key] = (flat * (2 * a) - a if init == "u" else flat).view(shape)
        elif init in "10":
            sd[key] = torch.full(shape, float(init), device=device)
    for key, shape, init, _ in leaves:
        if init == "g":
            v = sd[key[: -len("_g")] + "_v"]
            sd[key] = v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                   keepdim=True).sqrt()
    return sd


SPEAKER_POOL = 64         # seeded speaker rows the speakers are picked from


def _bias(p: torch.Tensor, frames: float) -> float:
    """The bias at which round(exp(p + bias) - 1) averages frames."""
    from reference import tte as ref_tte
    lo, hi = -8.0, 8.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = ((mid, hi) if ref_tte.durations(p + mid).double().mean()
                  < frames else (lo, mid))
    return hi


def calibrate(tte: dict, config: dict, pool: torch.Tensor | None) -> float:
    """Over 32 texts of the bulk mix's lengths, drawn from a fixed seed
    (the reference's encoder, IEEE float32): with several speakers, row j
    of the speaker table becomes the row of the table and `pool` whose
    frames a character, at the bias that sets the whole pool's mean to
    the assumed frames a character, lie nearest "frames_per_character_
    by_speaker"[j]; then the duration predictor's output bias at which
    round(exp(p) - 1) averages the assumed frames a character, the
    speakers in turn over the texts."""
    from harness import traffic
    from reference import ieee
    from reference import text as ref_text
    from reference import tte as ref_tte

    tcfg, assumed = config["tte"], config["assumed"]
    mix = {"requests_per_call": 32, "chars": {
        "dist": "normal", "mean": 100, "sd": 40, "min": 17, "max": 190}}
    n = tcfg["n_speaker"]
    frames = assumed["frames_per_character"]
    tte["duration_predictor.proj.bias"].zero_()
    with ieee():
        states = [ref_tte.encoder_states(tte, tcfg, ref_text.tokenize(
            r.text, assumed["characters"])) for r in traffic.call(
                mix, 0, 1, 0, "calibration")]
        if n > 1:
            table = tte["speaker_emb.weight"]
            rows = torch.cat([table, pool])
            p = torch.cat([ref_tte.log_durations(tte, tcfg, x + rows[:, None])
                           for x in states], dim=1)
            rate = ref_tte.durations(p + _bias(p, frames)).double().mean(1)
            for j, want in enumerate(assumed["frames_per_character_by_speaker"]):
                k = int(torch.argmin((rate - want).abs()))
                table[j] = rows[k]
                rate[k] = math.inf
            states = [x + table[i % n] for i, x in enumerate(states)]
        p = torch.cat([ref_tte.log_durations(tte, tcfg, x) for x in states])
        return _bias(p, frames)


def make(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(TTE state, vocoder state) for `seed` on `device`."""
    tcfg = config["tte"]
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        tte = _fill(_tte_leaves(tcfg), gen, device)
        voc = _fill(_vocoder_leaves(config["vocoder"]), gen, device)
        pool = (torch.randn(SPEAKER_POOL - tcfg["n_speaker"], tcfg["d_model"],
                            generator=gen, device=device)
                if tcfg["n_speaker"] > 1 else None)
        tte["tok_emb.weight"][tcfg["pad_idx"]] = 0.0
        tte["duration_predictor.proj.weight"] *= \
            config["assumed"]["duration_weight_scale"]
        tte["duration_predictor.proj.bias"].fill_(
            calibrate(tte, config, pool))
    return tte, voc
