"""The port's manifest entry points (parrot_tts_tpu_torch.infer.tte_infer.
{predict_units, write_predictions}, infer.synthesize.synthesize_text)
against the JAX package's, on the same weights (a seeded JAX init carried
across by convert.py) and the same corpus.

predictions.txt must be the same text (units are exact under both
packages' exact decode); synthesize_text's waveform within atol 1e-5 of
the JAX package's (float32 convs in another order).
"""

import ast
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import TTEModelConfig as JaxTTEConfig
from parrot_tts_tpu.core.config import TransformerStackConfig as JaxStack
from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.data.tte_data import TTEDataset as JaxTTEDataset
from parrot_tts_tpu.infer import synthesize as jax_synthesize
from parrot_tts_tpu.infer import tte_infer as jax_tte_infer
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.text.cleaners import english_cleaners as jax_cleaners
from parrot_tts_tpu.text.tokenizer import DFATokenizer as JaxTokenizer
from parrot_tts_tpu_torch.convert import (generator_state_from_jax,
                                          tte_state_from_jax)
from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                              TransformerStackConfig,
                                              VocoderModelConfig)
from parrot_tts_tpu_torch.data.audio_io import write_wav
from parrot_tts_tpu_torch.data.manifest import write_manifest
from parrot_tts_tpu_torch.data.tte_data import TTEDataset
from parrot_tts_tpu_torch.infer import synthesize, tte_infer
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.text.cleaners import english_cleaners
from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

SYMBOLS = [" "] + list("abcdefghiklmnoprstuwy,.")
TTE = dict(d_model=32, conv_n_filter=64, conv_kernel_sizes=(9, 1),
           max_len=500, dur_n_filter=16, dur_kernel_size=3, hubert_codes=40,
           n_speaker=2, vocab_size=len(SYMBOLS) + 2)
VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),), num_embeddings=40,
           embedding_dim=8, model_in_dim=16, num_speakers=2)
# decode plan of write_predictions: buckets of 8 and 16 tokens, 4 frames per
# token, under a duration head that predicts ~5: every sample overflows
# its first bucket and is decoded again
PLAN = dict(src_buckets=(8, 16), out_len_per_token=4, batch_size=3)


def _stack(cls):
    return dict(encoder=cls(1, 2), decoder=cls(1, 2))


@functools.lru_cache(maxsize=None)
def jax_weights(frames_per_token):
    """Seeded JAX weights (numpy), the duration head biased to about
    frames_per_token - 1 frames per token."""
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


def port_tte(tte) -> parrot.Parrot:
    tcfg = TTEModelConfig(**TTE, **_stack(TransformerStackConfig))
    model = parrot.Parrot(tcfg)
    model.load_state_dict(tte_state_from_jax(tte, tcfg), strict=True)
    return model.eval()


def write_corpus(tmp_path, n=7, seed=0):
    """A TTE val split of n utterances (3-20 tokens, so both buckets and
    the cropping of the largest); the first three have wav files, the
    rest do not (duration falls back to the code count)."""
    rng = np.random.default_rng(seed)
    align = tmp_path / "aligner"
    align.mkdir()
    (align / "symbols.json").write_text(json.dumps(SYMBOLS))
    root = tmp_path / "tte"
    root.mkdir()
    (root / "speakers.json").write_text(json.dumps({"en_f": 0, "en_m": 1}))
    letters = [s for s in SYMBOLS if s != " "] + ["sil"]
    entries = []
    for i in range(n):
        n_tok = int(rng.integers(3, 21))
        durs = rng.integers(1, 4, size=n_tok)
        audio = tmp_path / "wavs" / f"en_f_{i:03d}.wav"
        if i < 3:
            write_wav(audio, rng.uniform(-0.3, 0.3, 1600 + 160 * i), 16000)
        entries.append({
            "audio": str(audio),
            "characters": " ".join(rng.choice(letters, size=n_tok)),
            "hubert": " ".join(map(str, rng.integers(0, 40, int(durs.sum())))),
            "duration": " ".join(map(str, durs)),
            "speaker": ("en_f", "en_m")[i % 2]})
    write_manifest(root / "val.txt", entries)
    return root, align


def test_write_predictions_matches_jax(tmp_path, monkeypatch):
    root, align = write_corpus(tmp_path)
    jcfg, tte, _, _ = jax_weights(6.0)
    with pytest.warns(UserWarning, match="4/7 audio files were unreadable"):
        want = jax_tte_infer.write_predictions(
            jax.tree_util.tree_map(jnp.asarray, tte),
            JaxTTEDataset(root, align, "val", TTE["hubert_codes"]), jcfg,
            tmp_path / "jax" / "predictions.txt", **PLAN)
    calls = []
    real = parrot.infer_codes

    def spy(model, batch, *, out_len, **kw):
        calls.append(out_len)
        return real(model, batch, out_len=out_len, **kw)

    monkeypatch.setattr(parrot, "infer_codes", spy)
    ds = TTEDataset(root, align, "val", TTE["hubert_codes"])
    with pytest.warns(UserWarning, match="4/7 audio files were unreadable"):
        got = tte_infer.write_predictions(
            port_tte(tte), ds, tmp_path / "port" / "predictions.txt",
            device="cpu", **PLAN)
    assert got.read_text() == want.read_text()
    lines = got.read_text().splitlines()
    assert len(lines) == 7
    assert all(ast.literal_eval(x)["hubert"] for x in lines)
    assert ast.literal_eval(lines[0])["duration"] == 0.1
    # first passes at 32 and 64 frames, then the overflow re-decodes
    assert {32, 64} <= set(calls) and max(calls) > 64


@pytest.mark.parametrize("frames_per_token", [3.0, 40.0])
def test_synthesize_text_matches_jax(frames_per_token, monkeypatch):
    """At ~2 frames per token the first decode fits; at ~39 it overflows
    the s_len * 16 bucket and is decoded again at the length it needs."""
    jcfg, tte, vcfg, voc = jax_weights(frames_per_token)
    text = "the cats sat by a window"
    want = jax_synthesize.synthesize_text(
        text, tte_params=jax.tree_util.tree_map(jnp.asarray, tte),
        tte_cfg=jcfg, tokenizer=JaxTokenizer(SYMBOLS),
        synthesizer=jax_synthesize.VocoderSynthesizer(voc, vcfg),
        cleaner=jax_cleaners, speaker_id=1)
    calls = []
    real = parrot.infer_codes

    def spy(model, batch, *, out_len, **kw):
        calls.append(out_len)
        return real(model, batch, out_len=out_len, **kw)

    monkeypatch.setattr(parrot, "infer_codes", spy)
    vcfg_port = VocoderModelConfig(**VOC)
    got = synthesize.synthesize_text(
        text, tte_model=port_tte(tte), tokenizer=DFATokenizer(SYMBOLS),
        synthesizer=synthesize.VocoderSynthesizer(
            generator_state_from_jax(voc, vcfg_port), vcfg_port,
            device="cpu"),
        cleaner=english_cleaners, speaker_id=1, device="cpu")
    n_tok = len(text)
    assert calls[0] == n_tok * 16
    assert len(calls) == (2 if frames_per_token > 16 else 1)
    assert got.shape == want.shape and got.size > 0
    assert got.size % vcfg_port.total_upsample == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_predict_units_do_not_depend_on_the_batch(tmp_path):
    root, align = write_corpus(tmp_path)
    _, tte, _, _ = jax_weights(6.0)
    model = port_tte(tte)
    ds = TTEDataset(root, align, "val", TTE["hubert_codes"])
    kw = dict(src_buckets=(8, 16), out_len_per_token=4, device="cpu")
    one = tte_infer.predict_units(model, ds, batch_size=1, **kw)
    assert one == tte_infer.predict_units(model, ds, batch_size=16, **kw)
