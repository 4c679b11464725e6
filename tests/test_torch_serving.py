"""Port serving (parrot_tts_tpu_torch.infer) against the JAX package's
ParrotTTS(exact=True), end to end on the same texts and weights."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import TTEModelConfig as JaxTTEConfig
from parrot_tts_tpu.core.config import TransformerStackConfig as JaxStack
from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.infer.serving import ParrotTTS as JaxParrotTTS
from parrot_tts_tpu.infer.tte_infer import decode_buckets as jax_decode_buckets
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.models.tte.fold import fold_tte_params as jax_fold
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.text.cleaners import english_cleaners as jax_cleaners
from parrot_tts_tpu.text.tokenizer import DFATokenizer as JaxTokenizer
from parrot_tts_tpu_torch.convert import (generator_state_from_jax,
                                          tte_state_from_jax)
from parrot_tts_tpu_torch.data.tte_data import pick_bucket
from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                              TransformerStackConfig,
                                              VocoderModelConfig)
from parrot_tts_tpu_torch.infer.serving import ParrotTTS
from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets, max_decode_len
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.text.cleaners import english_cleaners
from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

SYMBOLS = [" "] + list("abcdefghiklmnoprstuwy,.")
TTE = dict(d_model=32, conv_n_filter=64, conv_kernel_sizes=(9, 1),
           max_len=500, dur_n_filter=16, dur_kernel_size=3, hubert_codes=40,
           n_speaker=3, vocab_size=len(SYMBOLS) + 2)
VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),), num_embeddings=40,
           embedding_dim=8, model_in_dim=16, num_speakers=3)
TEXTS = ["hello world.", "the cats sat down by a window",
         "yes, it is so", "more text, for the second bucket"]
SRC_BUCKETS = (16, 32)
SPEAKERS = [0, 1, 2, 1]


def _stack(cls):
    return dict(encoder=cls(1, 2), decoder=cls(2, 2))


@functools.lru_cache(maxsize=None)
def jax_weights(frames_per_token=3.0):
    """Seeded JAX weights (numpy), the duration head biased to about
    frames_per_token - 1 frames per token so decodes are not empty."""
    jcfg = JaxTTEConfig(**TTE, **_stack(JaxStack))
    tte = jax.jit(jax_parrot.init_parrot, static_argnums=1)(
        jax.random.key(0), jcfg)
    dp = tte["duration_predictor"]["proj"]
    dp["w"] = dp["w"] * 0.2
    dp["b"] = jnp.asarray([np.log(frames_per_token)], jnp.float32)
    vcfg = JaxVocoderConfig(**VOC)
    voc = jax.jit(jax_gen.init_code_generator, static_argnums=1)(
        jax.random.key(1), vcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return jcfg, to_np(tte), vcfg, to_np(voc)


def port_configs():
    return (TTEModelConfig(**TTE, **_stack(TransformerStackConfig)),
            VocoderModelConfig(**VOC))


def port_tts(tte, voc, **kw):
    tcfg, vcfg = port_configs()
    return ParrotTTS(tte_state_from_jax(tte, tcfg), tcfg,
                     generator_state_from_jax(voc, vcfg), vcfg,
                     DFATokenizer(SYMBOLS), english_cleaners,
                     src_buckets=SRC_BUCKETS, device="cpu", **kw)


@pytest.mark.parametrize("text", [
    "Dr. Smith paid $3.50 for 2 apples on the 21st.",
    "Café déjà vu — naïve “quotes”, 1,000,000 and 1999!",
    "  Mixed   CASE\twhitespace, Mr. and Mrs. Jones.  ",
])
def test_text_copies_match_jax(text):
    """The port's copies of the cleaners and DFATokenizer give the JAX
    package's cleaned text and token ids."""
    assert english_cleaners(text) == jax_cleaners(text)
    symbols = sorted(set(english_cleaners(text)))
    port, ref = DFATokenizer(symbols), JaxTokenizer(symbols)
    assert port.symbols == ref.symbols and port.stoi == ref.stoi
    seq = " ".join("sil" if c == " " else c for c in english_cleaners(text))
    assert port.tokenize_text(seq) == ref.tokenize_text(seq)


def test_tts_matches_jax_end_to_end():
    jcfg, tte, vcfg, voc = jax_weights()
    ref = JaxParrotTTS(tte, jcfg, voc, vcfg, JaxTokenizer(SYMBOLS),
                       jax_cleaners, src_buckets=SRC_BUCKETS, exact=True)
    want = ref.tts(TEXTS, speakers=SPEAKERS)
    tts = port_tts(tte, voc)
    got = tts.tts(TEXTS, speakers=SPEAKERS)

    tokens = [tts.tokenize(t) for t in TEXTS]
    units = tts.predict_units(tokens, SPEAKERS)
    want_units = ref.predict_units(tokens, SPEAKERS)
    folded = jax_fold(tte)
    for seq, spk, u, w_u in zip(tokens, SPEAKERS, units, want_units):
        assert len(u) == len(w_u) > 0                  # durations exact
        # codes agree wherever the JAX decode has no near-tie (margin rule)
        s_len = pick_bucket(SRC_BUCKETS, len(seq))
        out_len = -(-s_len * 16 // 128) * 128
        batch = {"phones": jnp.asarray(np.pad(seq, (0, s_len - len(seq)))[None]),
                 "src_mask": jnp.asarray((np.arange(s_len) < len(seq))[None]),
                 "speaker": jnp.asarray([spk])}
        with jax.default_matmul_precision("highest"):
            logits, mask, _ = jax_parrot.apply_parrot(
                folded, batch, jcfg, out_len=out_len, inference=True)
        top2 = np.sort(np.asarray(logits)[0][np.asarray(mask)[0]], -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(u[clear], w_u[clear])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
    st = tts.last_stats
    assert st["decode_batches"] == 2 and st["audio_seconds_per_second"] > 0
    assert st["tte_s"] + st["vocoder_s"] == pytest.approx(st["wall_s"])


def test_overflow_redecodes_in_larger_bucket(rng):
    """~30 frames per token: an 8-token sample overflows the 128-frame
    bucket and is re-decoded at the needed length, as in the JAX package."""
    jcfg, tte, _, _ = jax_weights(frames_per_token=30.0)
    tcfg, _ = port_configs()
    model = parrot.Parrot(tcfg)
    model.load_state_dict(tte_state_from_jax(tte, tcfg), strict=True)
    phones = rng.integers(2, TTE["vocab_size"], size=8).astype(np.int32)

    units = decode_buckets(model.eval(), [(phones, 1)], [(8, 128, [0])],
                           batch_size=4, device="cpu")
    infer = jax.jit(jax_parrot.infer_codes,
                    static_argnames=("cfg", "out_len", "exact"))
    want = jax_decode_buckets(infer, jax_fold(tte), jcfg, [(phones, 1)],
                              [(8, 128, [0])], batch_size=4)
    codes, mask, total = parrot.infer_codes(
        model, {"phones": phones[None], "src_mask": np.ones((1, 8), bool),
                "speaker": np.array([1])},
        out_len=max_decode_len(tcfg), device="cpu")
    assert 128 < int(total[0]) == len(units[0]) == len(want[0])
    np.testing.assert_array_equal(units[0], codes[0][mask[0]].numpy())


def test_empty_text_gives_empty_waveform():
    _, tte, _, voc = jax_weights()
    tts = port_tts(tte, voc)
    wavs = tts.tts(["", "hello there", "!!!"], speakers=[0, 1, 2])
    assert wavs[0].shape == (0,) and wavs[2].shape == (0,)
    assert len(wavs[1]) == len(tts.predict_units(
        [tts.tokenize("hello there")], [1])[0]) * 8


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """No device argument means the CUDA card; without one they raise
    instead of carrying on on the CPU."""
    from parrot_tts_tpu_torch.models.vocoder import generator as gen

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tte, _, voc = jax_weights()
    tcfg, vcfg = port_configs()
    args = (tte_state_from_jax(tte, tcfg), tcfg,
            generator_state_from_jax(voc, vcfg), vcfg, DFATokenizer(SYMBOLS),
            english_cleaners)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParrotTTS(*args)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        ParrotTTS(*args, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parrot.infer_codes(parrot.Parrot(tcfg), {
            "phones": np.ones((1, 4)), "src_mask": np.ones((1, 4), bool),
            "speaker": np.zeros(1)}, out_len=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen.apply_code_generator(gen.CodeGenerator(vcfg), np.zeros((1, 4)),
                                 np.zeros(1))


def test_exact_false_allows_tf32(monkeypatch):
    """exact=False runs the TTE and the vocoder with TF32 allowed for
    cuBLAS and cuDNN, and nondeterministic cuDNN algorithms, restoring the
    flags afterwards. The CPU has no TF32, so there it serves the same
    units and bits as exact=True."""
    from parrot_tts_tpu_torch.models.vocoder import generator as gen

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.deterministic)
    seen = []
    for mod, name in ((parrot, "apply_parrot"), (gen, "_code_generator")):
        def spy(*a, _real=getattr(mod, name), **kw):
            seen.append(flags())
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    before = flags()
    _, tte, _, voc = jax_weights()
    want = port_tts(tte, voc).tts(TEXTS, speakers=SPEAKERS)
    assert seen and set(seen) == {(False, False, True)}
    seen.clear()
    got = port_tts(tte, voc, exact=False).tts(TEXTS, speakers=SPEAKERS)
    assert seen and set(seen) == {(True, True, False)}
    assert flags() == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
