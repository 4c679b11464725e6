"""The yardstick: peaks of the card, and the operations and bytes that the
mathematics of Parrot-TTS serving needs, counted once (no 3x for a 3xTF32
split) and at each row's own lengths (valid queries x valid keys for
attention, trimmed samples for the MRF), so that no implementation, one
that skips padding or one that changes precision, can read above its
bound. An operation is a multiply or an add (a multiply-add is 2).

Peaks: NVIDIA's H100 SXM data sheet, dense. float32 work is set against
the TF32 tensor-core rate, the fastest a float32-accurate product can
use; bf16 work against the bf16 rate; bytes against HBM3's rate.
"""

PEAK = {"float32": 494.7e12, "bfloat16": 989e12}     # FLOP/s
HBM = 3.35e12                                        # bytes/s
ITEM = {"float32": 4, "bfloat16": 2}                 # bytes per value


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card can take: the larger of ops at the peak
    and bytes at HBM's rate."""
    return max(ops / PEAK[dtype], nbytes / HBM)


# --- row 1: attention, one launch per (decode batch, FFT block) ---------

def attention_launch(lengths, n_head: int, d_head: int) -> tuple[float, float]:
    """(ops, bytes) of softmax(Q K^T) V over a batch whose rows have the
    given valid lengths (queries = keys = the row's length): Q K^T and
    P V, 2 * L^2 * d each per head; Q, K, V read and O written once in
    float32."""
    ops = sum(4.0 * n_head * L * L * d_head for L in lengths)
    nbytes = sum(4.0 * 4 * n_head * L * d_head for L in lengths)
    return ops, nbytes


def attention_bound_s(launches, n_head: int, d_head: int) -> float:
    """Sum of the bounds of launches, each a list of row lengths."""
    return sum(bound_s(*attention_launch(rows, n_head, d_head), "float32")
               for rows in launches)


# --- row 6: the fused MRF, one stage of ResBlock1s ---------------------

def mrf_stage(samples: float, channels: int, kernel_sizes, dilations,
              dtype: str, weights: bool = True) -> tuple[float, float]:
    """(ops, bytes) of one stage's MRF over `samples` trimmed samples:
    per ResBlock1 and dilation two C x C convs of its kernel (2 * K * C^2
    per sample each); x read and the output written once, the weights
    and biases read once."""
    taps = sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))
    ops = 2.0 * samples * channels * channels * taps
    nbytes = ITEM[dtype] * 2.0 * samples * channels
    if weights:
        nbytes += ITEM[dtype] * (taps * channels * channels
                                 + 2 * sum(map(len, dilations)) * channels)
    return ops, nbytes


def fused_stages(vcfg: dict, below: int = 128) -> list[tuple[int, int, int]]:
    """(stage, channels, samples per code) of the stages the fused MRF
    runs: ResBlock1 stages of fewer than `below` channels."""
    out, hop = [], 1
    for i, u in enumerate(vcfg["upsample_rates"]):
        hop *= u
        c = vcfg["upsample_initial_channel"] // 2 ** (i + 1)
        if vcfg.get("resblock", "1") == "1" and c < below:
            out.append((i, c, hop))
    return out


def mrf_bound_s(unit_counts, vcfg: dict, dtype: str) -> float:
    """Bound of the fused MRF over requests of the given unit counts: per
    stage, every request's trimmed samples together (one set of weights
    per stage and request batch is left out: a lower bound)."""
    total = 0.0
    for _, c, hop in fused_stages(vcfg):
        samples = sum(unit_counts) * hop
        total += bound_s(*mrf_stage(samples, c, vcfg["resblock_kernel_sizes"],
                                    vcfg["resblock_dilation_sizes"], dtype,
                                    weights=False), dtype)
    return total


# --- the whole serve ---------------------------------------------------

def tte_ops(cfg: dict, tokens: int, frames: int) -> float:
    """Operations of one request's TTE decode at its own lengths: the
    encoder over its tokens, the duration predictor, the decoder over its
    frames and the head. Attention's projections are counted folded (one
    in- and one out-projection), the least the mathematics needs."""
    d, nf = cfg["d_model"], cfg["conv_n_filter"]
    k1, k2 = cfg["conv_kernel_sizes"]

    def block(n):
        proj = 2.0 * n * 4 * d * d
        attn = 4.0 * n * n * d
        conv = 2.0 * n * d * nf * (k1 + k2)
        return proj + attn + conv

    dn, dk = cfg["dur_n_filter"], cfg["dur_kernel_size"]
    dur = 2.0 * tokens * dk * (d * dn + dn * dn) + 2.0 * tokens * dn
    head = 2.0 * frames * d * cfg["hubert_codes"]
    return (cfg["encoder"]["n_layer"] * block(tokens) + dur
            + cfg["decoder"]["n_layer"] * block(frames) + head)


def vocoder_ops(vcfg: dict, units: int) -> float:
    """Operations of one request's vocoder at its own units: conv_pre,
    each stage's transposed conv and MRF, conv_post."""
    c0 = vcfg["upsample_initial_channel"]
    ops = 2.0 * units * vcfg["model_in_dim"] * c0 * 7
    t, cin = units, c0
    for i, (u, k) in enumerate(zip(vcfg["upsample_rates"],
                                   vcfg["upsample_kernel_sizes"])):
        c = c0 // 2 ** (i + 1)
        ops += 2.0 * t * cin * c * k
        t *= u
        per = 1 if vcfg.get("resblock", "1") == "2" else 2
        taps = sum(len(dl) * per * kk
                   for kk, dl in zip(vcfg["resblock_kernel_sizes"],
                                     vcfg["resblock_dilation_sizes"]))
        ops += 2.0 * t * c * c * taps
        cin = c
    return ops + 2.0 * t * cin * 7


def receptive_reach(vcfg: dict) -> int:
    """How many output samples before its end a waveform still depends
    on code frames after its end (an upper bound): the conv reaches of
    every layer, each in output samples."""
    hop_total = 1
    for u in vcfg["upsample_rates"]:
        hop_total *= u
    per = hop_total                     # output samples per code frame
    reach = 3 * per                     # conv_pre, k = 7
    for u, k in zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"]):
        pad = (k - u) // 2
        reach += (-(-pad // u) + 1) * per    # the transposed conv's inputs
        per //= u
        reach += per * max(sum((kk - 1) // 2 * (dd + 1) for dd in dl)
                           for kk, dl in zip(vcfg["resblock_kernel_sizes"],
                                             vcfg["resblock_dilation_sizes"]))
    return reach + 3 * per              # conv_post, k = 7
