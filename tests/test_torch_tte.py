"""Port TTE (parrot_tts_tpu_torch.models.tte) against the JAX package.

Same weights (a seeded JAX init carried across by convert.py) and the same
numpy inputs through both. Tolerances: float32 sums in another order on
the two CPU backends; lengths and units must be exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import TTEModelConfig as JaxTTEConfig
from parrot_tts_tpu.core.config import TransformerStackConfig as JaxStack
from parrot_tts_tpu.models.tte import fft as jax_fft
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.ops import length_regulator as jax_lr
from parrot_tts_tpu_torch.convert import tte_state_from_jax
from parrot_tts_tpu_torch.core.config import TTEModelConfig, TransformerStackConfig
from parrot_tts_tpu_torch.models.tte import fft, parrot
from parrot_tts_tpu_torch.models.tte.fold import fold_tte_params
from parrot_tts_tpu_torch.ops import length_regulator as lr

CFG = dict(d_model=32, conv_n_filter=64, conv_kernel_sizes=(9, 1),
           max_len=500, dur_n_filter=16, dur_kernel_size=3, hubert_codes=50,
           n_speaker=3, vocab_size=20, pad_idx=0)
N_LAYER, N_HEAD = 2, 2


def configs():
    jcfg = JaxTTEConfig(**CFG, encoder=JaxStack(N_LAYER, N_HEAD),
                        decoder=JaxStack(N_LAYER, N_HEAD))
    tcfg = TTEModelConfig(**CFG, encoder=TransformerStackConfig(N_LAYER, N_HEAD),
                          decoder=TransformerStackConfig(N_LAYER, N_HEAD))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def jax_params(jcfg, seed=0, frames_per_token=4.0):
    """Seeded JAX init with the duration head biased to ~frames_per_token-1
    frames per token, so decodes are not empty (numpy leaves; read-only)."""
    p = jax.jit(jax_parrot.init_parrot, static_argnums=1)(
        jax.random.key(seed), jcfg)
    dp = p["duration_predictor"]["proj"]
    dp["w"] = dp["w"] * 0.2
    dp["b"] = jnp.asarray([np.log(frames_per_token)], jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def port_model(params, tcfg):
    m = parrot.Parrot(tcfg)
    m.load_state_dict(tte_state_from_jax(params, tcfg), strict=True)
    return m.eval()


def make_batch(rng, lengths, s_len, vocab, n_speaker):
    b = len(lengths)
    phones = np.zeros((b, s_len), np.int32)
    src_mask = np.zeros((b, s_len), bool)
    for i, n in enumerate(lengths):
        phones[i, :n] = rng.integers(2, vocab, size=n)
        src_mask[i, :n] = True
    speaker = rng.integers(0, n_speaker, size=b).astype(np.int32)
    return {"phones": phones, "src_mask": src_mask, "speaker": speaker}


def test_fft_block_matches_jax(rng):
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    model = port_model(params, tcfg)
    x = rng.standard_normal((3, 37, CFG["d_model"])).astype(np.float32)
    mask = np.arange(37)[None, :] >= np.array([37, 20, 5])[:, None]

    want = jax_fft.apply_fft_block(
        params["encoder_layers"][0], jnp.asarray(x),
        kernel_sizes=CFG["conv_kernel_sizes"], n_head=N_HEAD,
        key_padding_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = fft.apply_fft_block(model.encoder_layers[0], torch.from_numpy(x),
                                  key_padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_duration_predictor_matches_jax(rng):
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    model = port_model(params, tcfg)
    x = rng.standard_normal((2, 23, CFG["d_model"])).astype(np.float32)
    pad = np.arange(23)[None, :] >= np.array([23, 9])[:, None]

    want = jax_parrot.apply_duration_predictor(
        params["duration_predictor"], jnp.asarray(x), jnp.asarray(pad), jcfg)
    with torch.no_grad():
        got = parrot.apply_duration_predictor(
            model.duration_predictor, torch.from_numpy(x),
            torch.from_numpy(pad), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    assert (got.numpy()[pad] == 0).all()


def test_pos_table_and_pe_row_quirk():
    _, tcfg = configs()
    pe = parrot.pos_table(tcfg)
    assert pe.shape == (512, CFG["d_model"])          # padded to 128 rows
    np.testing.assert_array_equal(
        pe, np.asarray(jax_parrot.pos_table(configs()[0])))
    x = torch.zeros(2, 5, CFG["d_model"])
    out = fft.add_pos_emb(x, torch.from_numpy(pe), torch.tensor([3, 999]))
    np.testing.assert_array_equal(out[0].numpy(), np.broadcast_to(pe[3], (5, 32)))
    np.testing.assert_array_equal(out[1].numpy(), np.broadcast_to(pe[511], (5, 32)))


def test_length_regulator_exact(rng):
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    dur = rng.integers(0, 5, size=(3, 7)).astype(np.int32)
    dur[2] = 0                                    # an all-zero sample
    dur[1, 5:] = 0                                # padding tokens carry 0
    for out_len in (16, 40):
        want_x, want_m = jax_lr.length_regulator(jnp.asarray(x),
                                                 jnp.asarray(dur), out_len)
        got_x, got_m = lr.length_regulator(torch.from_numpy(x),
                                           torch.from_numpy(dur), out_len)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_durations_round_half_to_even():
    p = np.log(np.array([1.5, 2.5, 3.5, 0.2, 4.49], np.float64) + 1.0)
    p = p.astype(np.float32)
    want = np.asarray(jax_lr.durations_from_log_pred(jnp.asarray(p)))
    got = lr.durations_from_log_pred(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_folded_params_same_decode(rng):
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    state = tte_state_from_jax(params, tcfg)
    folded = parrot.Parrot(tcfg, folded=True)
    folded.load_state_dict(fold_tte_params(state), strict=True)
    batch = make_batch(rng, [12, 7], 16, CFG["vocab_size"], CFG["n_speaker"])
    c1, m1, t1 = parrot.infer_codes(port_model(params, tcfg), batch,
                                    out_len=128, device="cpu")
    c2, m2, t2 = parrot.infer_codes(folded.eval(), batch, out_len=128,
                                    device="cpu")
    assert torch.equal(t1, t2) and torch.equal(m1, m2)
    assert torch.equal(c1[m1], c2[m2])


@pytest.mark.parametrize("out_len", [128, 512])
def test_infer_codes_exact_matches_jax(rng, out_len):
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    model = port_model(params, tcfg)
    batch = make_batch(rng, [14, 9, 3], 16, CFG["vocab_size"],
                       CFG["n_speaker"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    with jax.default_matmul_precision("highest"):
        j_logits, j_mask, j_logdur = jax_parrot.apply_parrot(
            params, jbatch, jcfg, out_len=out_len, inference=True)
    j_codes, _, j_total = jax_parrot.infer_codes(params, jbatch, jcfg,
                                                 out_len=out_len, exact=True)
    j_logits, j_mask = np.asarray(j_logits), np.asarray(j_mask)
    j_dur = np.where(batch["src_mask"], np.asarray(
        jax_lr.durations_from_log_pred(j_logdur)), 0)

    tb = parrot.to_batch(batch, torch.device("cpu"))
    with torch.no_grad():
        logits, mask, logdur = parrot.apply_parrot(model, tb, out_len=out_len)
    codes, mask2, total = parrot.infer_codes(model, batch, out_len=out_len,
                                             device="cpu")
    dur = torch.where(tb["src_mask"], lr.durations_from_log_pred(logdur), 0)

    np.testing.assert_allclose(logdur.numpy(), np.asarray(j_logdur),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(dur.numpy(), j_dur)
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_array_equal(mask2.numpy(), j_mask)
    np.testing.assert_array_equal(total.numpy(), np.asarray(j_total))
    assert j_mask.sum() > 20                     # the decode is not empty
    np.testing.assert_allclose(logits.numpy()[j_mask], j_logits[j_mask],
                               atol=5e-4, rtol=0)
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    clear = j_mask & (top2[..., 1] - top2[..., 0] > 1e-3)
    np.testing.assert_array_equal(codes.numpy()[clear],
                                  np.asarray(j_codes)[clear])


@pytest.mark.parametrize("mode", ["hybrid", "high", "selective_high", 1, None])
def test_infer_codes_refuses_what_is_not_its_mode(mode):
    """infer_codes takes True, False, "selective" and "selective-high";
    "hybrid" only a bucketed decode can run (decode_buckets, ParrotTTS),
    and anything else is an error."""
    _, tcfg = configs()
    batch = {"phones": np.ones((1, 4), np.int32),
             "src_mask": np.ones((1, 4), bool), "speaker": np.zeros(1)}
    with pytest.raises(ValueError, match="not a decode mode"):
        parrot.infer_codes(parrot.Parrot(tcfg), batch, out_len=64,
                           exact=mode, device="cpu")
