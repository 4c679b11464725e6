"""Port HuBERT unit extraction (parrot_tts_tpu_torch.{models.hubert,
infer.unit_extractor, pipeline.extract_units}, convert.hubert_state_from_jax)
against the JAX package on the CPU, at tiny widths.

Weights are the port's seeded init, read into the JAX package by its own
`params_from_state_dict` (the port's modules carry HF HubertModel's
state_dict keys). Tolerances: features within FEAT_ATOL (float32 sums in
another order; measured ~2e-6 after two post-LN layers). Codes: equal
wherever the nearest-centroid margin (second-best d^2 - best d^2) exceeds
MARGIN_REL * |x|^2 of the frame, and the frames below it are counted and
must be few.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core.config import HubertConfig as JaxHubertConfig
from parrot_tts_tpu.infer.unit_extractor import UnitExtractor as JaxExtractor
from parrot_tts_tpu.models.hubert import convert as jax_convert
from parrot_tts_tpu.models.hubert import model as jax_hub
from parrot_tts_tpu.pipeline.extract_units import (
    extract_units_corpus as jax_extract_units_corpus)
from parrot_tts_tpu_torch.convert import hubert_state_from_jax
from parrot_tts_tpu_torch.core.config import HubertConfig
from parrot_tts_tpu_torch.data.audio_io import write_wav
from parrot_tts_tpu_torch.data.manifest import read_manifest
from parrot_tts_tpu_torch.infer.unit_extractor import UnitExtractor
from parrot_tts_tpu_torch.models.hubert import convert
from parrot_tts_tpu_torch.models.hubert import model as hub
from parrot_tts_tpu_torch.pipeline.extract_units import extract_units_corpus

FEAT_ATOL = 1e-5
MARGIN_REL = 1e-4
TINY = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
            conv_stride=(5, 2, 2), d_model=32, n_layer=2, n_head=4,
            ffn_dim=64, pos_conv_groups=2, output_layer=2, max_chunk=6000)
# (feat_extract_norm, conv_bias, pos_conv_kernel, normalize_input): each
# option both ways, an even kernel (HF SamePadLayer) and an odd one
VARIANTS = [("group", False, 8, False), ("group", True, 7, True),
            ("layer", True, 8, True), ("layer", False, 7, False)]


def configs(norm="group", bias=False, k=8, normalize=False, **kw):
    args = dict(TINY, feat_extract_norm=norm, conv_bias=bias,
                pos_conv_kernel=k, normalize_input=normalize, **kw)
    return HubertConfig(**args), JaxHubertConfig(**args)


def port_model(cfg, seed=1):
    m = hub.HubertModel(cfg)
    gen = torch.Generator().manual_seed(seed)
    m.load_state_dict(hub.init_hubert(cfg, gen), strict=True)
    return m.eval()


def padded(wavs, bucket):
    batch = np.zeros((len(wavs), bucket), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    return batch, np.array([len(w) for w in wavs], np.int32)


def codes_and_margins(feats: torch.Tensor, centers: np.ndarray):
    """Nearest center of each frame and its margin relative to |x|^2."""
    d2 = hub.kmeans_distances(feats.double(), torch.from_numpy(
        centers).double())
    two = d2.topk(2, dim=-1, largest=False).values
    rel = (two[..., 1] - two[..., 0]) / feats.double().square().sum(-1)
    return d2.argmin(-1).numpy(), rel.numpy()


def assert_codes_match(got, want, margin, max_low=0.05):
    """Codes equal above the margin; the frames below it are few."""
    got, want, margin = (np.asarray(x).reshape(-1) for x in (got, want,
                                                              margin))
    sure = margin > MARGIN_REL
    np.testing.assert_array_equal(got[sure], want[sure])
    assert (~sure).mean() <= max_low, (~sure).sum()


@pytest.mark.parametrize("norm,bias,k,normalize", VARIANTS)
def test_apply_hubert_matches_jax(rng, norm, bias, k, normalize):
    """Features at layer 1 and the last, a padded batch equal to each wav
    at its exact length, codes equal above the margin."""
    cfg, jcfg = configs(norm, bias, k, normalize)
    model = port_model(cfg)
    params = jax_convert.params_from_state_dict(model.state_dict(), jcfg)
    lens = [1603, 2000, 2777]
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lens]
    batch, n = padded(wavs, 3200)
    centers = rng.standard_normal((12, cfg.d_model)).astype(np.float32)
    for layer in (1, cfg.n_layer):
        got, nf = hub.apply_hubert(model, batch, n, output_layer=layer,
                                   device="cpu")
        want, nf_j = jax_hub.apply_hubert(params, jnp.asarray(batch),
                                          jnp.asarray(n), jcfg,
                                          output_layer=layer)
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        for i, w in enumerate(wavs):
            t = int(nf[i])
            assert t == int(nf_j[i]) == hub.feat_extract_output_length(
                cfg, len(w))
            np.testing.assert_allclose(got[i, :t].numpy(), want[i, :t],
                                       rtol=0, atol=FEAT_ATOL)
            alone, _ = hub.apply_hubert(model, w[None], [len(w)],
                                        output_layer=layer, device="cpu")
            np.testing.assert_allclose(alone[0].numpy(), got[i, :t].numpy(),
                                       rtol=0, atol=FEAT_ATOL)
            codes, margin = codes_and_margins(got[i, :t], centers)
            want_codes = np.asarray(jax_hub.kmeans_predict(
                jnp.asarray(want[i, :t]), jnp.asarray(centers)))
            assert_codes_match(codes, want_codes, margin)


def test_apply_hubert_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _ = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        hub.apply_hubert(port_model(cfg), np.zeros((1, 800), np.float32),
                         [800])
    with pytest.raises(RuntimeError, match="CUDA"):
        UnitExtractor(port_model(cfg).state_dict(), cfg,
                      np.zeros((3, cfg.d_model), np.float32))


def test_kmeans_predict_matches_jax_lowest_index_on_ties(rng):
    x = rng.standard_normal((4, 50, 16)).astype(np.float32)
    centers = rng.standard_normal((20, 16)).astype(np.float32)
    centers[7] = centers[3]                 # duplicates: 3 must win
    centers[15] = centers[3]
    x[0, :5] = centers[3]                   # frames exactly on the duplicate
    got = hub.kmeans_predict(torch.from_numpy(x),
                             torch.from_numpy(centers)).numpy()
    want = np.asarray(jax_hub.kmeans_predict(jnp.asarray(x),
                                             jnp.asarray(centers)))
    np.testing.assert_array_equal(got, want)
    assert (got[0, :5] == 3).all() and not np.isin(got, (7, 15)).any()


@pytest.mark.parametrize("norm,bias", [("group", False), ("layer", True),
                                       ("layer", False)])
def test_hubert_state_round_trips_through_jax(norm, bias):
    """Port state -> JAX params_from_state_dict -> hubert_state_from_jax is
    the identity; a JAX init_hubert tree -> port -> JAX likewise where the
    two inits agree on the conv bias."""
    cfg, jcfg = configs(norm, bias)
    sd = port_model(cfg).state_dict()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_convert.params_from_state_dict(sd, jcfg))
    back = hubert_state_from_jax(tree, cfg)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    jtree = jax.tree_util.tree_map(
        np.asarray, jax_hub.init_hubert(jax.random.key(2), jcfg))
    state = hubert_state_from_jax(jtree, cfg)
    hub.HubertModel(cfg).load_state_dict(state, strict=True)
    again = jax.tree_util.tree_map(
        np.asarray, jax_convert.params_from_state_dict(state, jcfg))
    if norm == "layer" and not bias:        # JAX's init gives a zero bias
        for layer in jtree["conv_layers"]:
            assert not layer.pop("b").any()
    la, ta = jax.tree_util.tree_flatten(again)
    lb, tb = jax.tree_util.tree_flatten(jtree)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    jtree["conv_layers"][0]["b"] = np.ones(16, np.float32)
    if not bias:
        with pytest.raises(ValueError, match="bias"):
            hubert_state_from_jax(jtree, cfg)


def fairseq_names(sd: dict, parametrized: bool = False) -> dict:
    """HF HubertModel keys -> fairseq's (tests/test_hubert.py's map), the
    positional conv split into weight norm's g and v (dims 0, 1), as
    fairseq's weight_g / weight_v or torch >= 2.1's parametrization
    names."""
    fs = {}
    for k, v in sd.items():
        k2 = (k.replace(".attention.", ".self_attn.")
               .replace(".feed_forward.intermediate_dense.", ".fc1.")
               .replace(".feed_forward.output_dense.", ".fc2.")
               .replace("feature_projection.projection.", "post_extract_proj.")
               .replace("feature_projection.layer_norm.", "layer_norm.")
               .replace("encoder.pos_conv_embed.conv.", "encoder.pos_conv.0."))
        if ".layer_norm." in k2 and ".layers." in k2 and "final" not in k2:
            k2 = k2.replace(".layer_norm.", ".self_attn_layer_norm.")
        if k2.startswith("feature_extractor.conv_layers."):
            parts = k2.split(".")
            parts[3] = {"conv": "0", "layer_norm": "2"}[parts[3]]
            k2 = ".".join(parts)
        fs[k2] = v
    w = fs.pop("encoder.pos_conv.0.weight")
    g, v = ("parametrizations.weight.original0",
            "parametrizations.weight.original1") if parametrized else (
        "weight_g", "weight_v")
    fs["encoder.pos_conv.0." + g] = w.norm(dim=(0, 1), keepdim=True)
    fs["encoder.pos_conv.0." + v] = w
    fs["label_embs_concat"] = torch.zeros(3, 4)       # pretraining only
    return fs


@pytest.mark.parametrize("parametrized", [False, True])
def test_fairseq_key_scheme_and_config(parametrized):
    cfg, jcfg = configs("group", False, 8)
    sd = port_model(cfg).state_dict()
    fs = fairseq_names(sd, parametrized)
    state = convert.state_from_state_dict(fs)
    assert state.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=0)
    got = convert.config_from_state_dict(fs)
    for f in ("conv_dim", "conv_kernel", "conv_stride", "conv_bias",
              "feat_extract_norm", "d_model", "n_layer", "ffn_dim",
              "pos_conv_kernel", "pos_conv_groups"):
        assert getattr(got, f) == getattr(cfg, f), f
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_convert.config_from_state_dict(fs))
    # the port's fold equals the JAX package's, which folds in float64 too
    want = jax_convert.params_from_state_dict(fs, jcfg)["pos_conv"]["w"]
    np.testing.assert_array_equal(
        state["encoder.pos_conv_embed.conv.weight"].numpy(),
        np.asarray(want).transpose(2, 1, 0))


class FairseqConfig:     # stands in for a pickled fairseq / omegaconf class
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_load_hubert_from_checkpoint_files(tmp_path, monkeypatch):
    """An HF-style .bin and a fairseq-style .pt whose pickled config
    class no longer resolves."""
    cfg, _ = configs("layer", True, 7)
    sd = port_model(cfg).state_dict()
    torch.save(sd, tmp_path / "hf.bin")
    model, got_cfg = convert.load_hubert(tmp_path / "hf.bin", cfg)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    import sys
    import types

    monkeypatch.setattr(FairseqConfig, "__module__",
                        "fairseq_config_missing")

    fake = types.ModuleType("fairseq_config_missing")
    fake.FairseqConfig = FairseqConfig
    monkeypatch.setitem(sys.modules, "fairseq_config_missing",
                        fake)
    torch.save({"cfg": FairseqConfig(normalize=False),
                "model": fairseq_names(sd)}, tmp_path / "fs.pt")
    monkeypatch.delitem(sys.modules, "fairseq_config_missing")
    model, got_cfg = convert.load_hubert(tmp_path / "fs.pt")
    assert got_cfg.feat_extract_norm == "layer" and got_cfg.conv_bias
    for k, v in sd.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=0)


def test_load_kmeans_centers(tmp_path, rng):
    centers = rng.standard_normal((7, 5)).astype(np.float32)
    np.save(tmp_path / "c.npy", centers)
    np.savez(tmp_path / "c.npz", centers=centers)
    for name in ("c.npy", "c.npz"):
        np.testing.assert_array_equal(
            convert.load_kmeans_centers(tmp_path / name), centers)
    joblib = pytest.importorskip("joblib")
    pytest.importorskip("sklearn")
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=3, n_init=1, random_state=0).fit(
        rng.standard_normal((30, 5)))
    joblib.dump(km, tmp_path / "km.bin")
    np.testing.assert_allclose(
        convert.load_kmeans_centers(tmp_path / "km.bin"),
        km.cluster_centers_.astype(np.float32))


def test_hubert_matches_transformers(rng):
    """The port against transformers' HubertModel (the reference's fairseq
    encoder, HF naming) on HF's own state dict, weight-norm
    parametrization and all."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.HubertModel(transformers.HubertConfig(
        vocab_size=10, conv_dim=list(TINY["conv_dim"]),
        conv_kernel=list(TINY["conv_kernel"]),
        conv_stride=list(TINY["conv_stride"]), conv_bias=False,
        feat_extract_norm="group", hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
        do_stable_layer_norm=False, hidden_act="gelu", hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        layerdrop=0.0, apply_spec_augment=False)).eval()
    cfg = dataclasses.replace(convert.config_from_state_dict(hf.state_dict()),
                              n_head=4, output_layer=2)
    model = hub.HubertModel(cfg)
    model.load_state_dict(convert.state_from_state_dict(hf.state_dict()),
                          strict=True)
    wav = (rng.standard_normal(2000) * 0.1).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(wav[None]),
                  output_hidden_states=True).hidden_states
    for layer in (1, 2):
        got, _ = hub.apply_hubert(model, wav[None], [2000],
                                  output_layer=layer, device="cpu")
        np.testing.assert_allclose(got[0].numpy(), want[layer][0].numpy(),
                                   rtol=1e-4, atol=1e-4)


def write_corpus(root, rng, lens=(1800, 2400, 5000, 7100, 3900)):
    """Wavs under <speaker>/wavs/ (the last one past max_chunk 6000)."""
    for i, n in enumerate(lens):
        spk = ("en_f", "hi_m")[i % 2]
        write_wav(root / spk / "wavs" / f"{spk}_{i}.wav",
                  (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
    return root


def extractor_pair(rng, **kw):
    cfg, jcfg = configs()
    model = port_model(cfg)
    centers = rng.standard_normal((12, cfg.d_model)).astype(np.float32)
    args = dict(buckets=(2000, 4000, 6000), batch_size=2, **kw)
    port = UnitExtractor(model.state_dict(), cfg, centers, device="cpu",
                         **args)
    jax_ex = JaxExtractor(jax_convert.params_from_state_dict(
        model.state_dict(), jcfg), jcfg, centers, **args)
    return port, jax_ex, model, centers


def wav_margins(model, centers, wav, cfg):
    """The margins of one wav's codes, chunked as the extractor chunks."""
    out = []
    for s in range(0, len(wav), cfg.max_chunk):
        c = wav[s: s + cfg.max_chunk]
        feats, _ = hub.apply_hubert(model, c[None], [len(c)], device="cpu")
        out.append(codes_and_margins(feats[0], centers)[1])
    return np.concatenate(out)


def test_extract_units_corpus_matches_jax(tmp_path, rng):
    """hubert.txt equal to the JAX package's: paths, durations and, above
    the margin, codes; every wav has feat_extract_output_length codes."""
    root = write_corpus(tmp_path / "corpus", rng)
    port, jax_ex, model, centers = extractor_pair(rng)
    got = extract_units_corpus(port, root, tmp_path / "port")
    want = jax_extract_units_corpus(jax_ex, root, tmp_path / "jax")
    assert read_manifest(tmp_path / "port" / "hubert.txt") == got
    assert len(got) == len(want) == 5
    cfg = port.cfg
    for g, w in zip(got, want):
        assert g["audio"] == w["audio"] and g["duration"] == w["duration"]
        codes = np.array(g["hubert"].split(), np.int64)
        n = int(round(g["duration"] * 16000))
        chunks = [min(cfg.max_chunk, n - s)
                  for s in range(0, n, cfg.max_chunk)]
        assert len(codes) == sum(hub.feat_extract_output_length(cfg, c)
                                 for c in chunks)
        assert ((codes >= 0) & (codes < 12)).all()
        from parrot_tts_tpu_torch.data.audio_io import read_wav

        wav = read_wav(g["audio"])[0].astype(np.float32)
        assert_codes_match(codes, np.array(w["hubert"].split(), np.int64),
                           wav_margins(model, centers, wav, cfg))


def test_get_codes_chunks_at_max_chunk(rng):
    port, jax_ex, model, centers = extractor_pair(rng)
    wav = (rng.standard_normal(14000) * 3000).astype(np.float32)
    got = port.get_codes(wav)
    parts = [port.get_codes(wav[s: s + 6000]) for s in (0, 6000, 12000)]
    np.testing.assert_array_equal(got, np.concatenate(parts))
    assert got.dtype == np.int32
    assert_codes_match(got, jax_ex.get_codes(wav),
                       wav_margins(model, centers, wav, port.cfg))


def test_wavs_shorter_than_a_frame_get_no_codes(rng):
    """An empty wav, one under a frame (39 samples at the tiny strides),
    and a chunk tail under a frame past max_chunk give no codes, not the
    padding frames' (the length formula's fixed point is -1)."""
    port, _, _, _ = extractor_pair(rng)
    cfg = port.cfg
    assert hub.feat_extract_output_length(cfg, 0) == 0
    assert hub.feat_extract_output_length(cfg, 39) == 0
    assert hub.feat_extract_output_length(cfg, 40) == 1
    np.testing.assert_array_equal(hub.feat_extract_output_length(
        cfg, torch.tensor([0, 39, 40])), [0, 0, 1])
    wav = (rng.standard_normal(cfg.max_chunk + 30) * 0.1).astype(np.float32)
    empty = np.zeros(0, np.float32)
    assert len(port.get_codes(empty)) == 0
    np.testing.assert_array_equal(port.get_codes(wav),
                                  port.get_codes(wav[: cfg.max_chunk]))
    got = port.codes_for_wavs([empty, wav[:39], wav[:2000], wav])
    assert [len(c) for c in got] == [
        0, 0, hub.feat_extract_output_length(cfg, 2000),
        hub.feat_extract_output_length(cfg, cfg.max_chunk)]


def test_codes_for_wavs_options_agree(rng, tmp_path):
    """Every upload / readback option gives the default's codes, in order;
    those equal each wav's codes alone (above the margin), the wav past
    max_chunk included; a path at another sample rate is refused."""
    port, _, model, centers = extractor_pair(rng)
    lens = (1800, 2400, 5000, 1500, 3900, 7100, 1999)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lens]
    base = port.codes_for_wavs(wavs)
    for w, b in zip(wavs, base):
        assert_codes_match(b, port.get_codes(w),
                           wav_margins(model, centers, w, port.cfg))
    for upload_thread in (True, False):
        for defer in (False, True):
            got = port.codes_for_wavs(wavs, upload_thread=upload_thread,
                                      defer_readback=defer)
            assert len(got) == len(wavs)
            for g, b in zip(got, base):
                np.testing.assert_array_equal(g, b)
    write_wav(tmp_path / "x.wav", wavs[0], 8000)
    with pytest.raises(ValueError, match="sample rate"):
        port.get_codes_from_path(tmp_path / "x.wav")
