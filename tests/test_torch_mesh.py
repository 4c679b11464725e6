"""The port's mesh layer (parrot_tts_tpu_torch.core.mesh, data.tte_data's
per-process slice, data.prefetch, parallel.tensor's rules) against the
JAX package's, and sharded serving in one process over
create_mesh(["cpu"] * 4) against the JAX package's 8-device mesh serve
and the port's solo serve."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parrot_tts_tpu.core import mesh as jax_mesh
from parrot_tts_tpu.data import tte_data as jax_data
from parrot_tts_tpu.data.manifest import write_manifest
from parrot_tts_tpu.infer.synthesize import (
    VocoderSynthesizer as JaxSynthesizer)
from parrot_tts_tpu.infer.tte_infer import decode_buckets as jax_decode_buckets
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.models.tte.fold import fold_tte_params as jax_fold
from parrot_tts_tpu.parallel import partition_specs as jax_partition_specs
from parrot_tts_tpu.text.tokenizer import save_symbols
from parrot_tts_tpu_torch.convert import (generator_state_from_jax,
                                          tte_state_from_jax)
from parrot_tts_tpu_torch.core import mesh as meshlib
from parrot_tts_tpu_torch.core.config import MeshConfig, PipelineConfig
from parrot_tts_tpu_torch.data import tte_data
from parrot_tts_tpu_torch.data.prefetch import device_prefetch, threaded_loader
from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.tte.fold import fold_tte_params
from parrot_tts_tpu_torch.parallel import tensor as tp

from tests import test_torch_serving as serve_t
from tests import test_torch_vocoder as voc_t

CPU4 = ["cpu"] * 4


def test_mesh_config_and_create_mesh():
    assert PipelineConfig().mesh == MeshConfig()
    m = meshlib.create_mesh(["cpu"] * 8)
    assert m.shape == {"data": 8, "model": 1} and len(m.local_data) == 8
    m = meshlib.create_mesh(["cpu"] * 8, model_parallel_size=2)
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        m.local_data                # data-parallel paths want model axis 1
    with pytest.raises(ValueError):
        meshlib.create_mesh(["cpu"] * 3, model_parallel_size=2)


def test_create_mesh_refuses_missing_cuda_devices():
    """No device list means every CUDA device: none here, so it raises, as
    a list naming a CUDA device that does not exist does."""
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError):
        meshlib.create_mesh([f"cuda:{n}"])
    if n == 0:
        with pytest.raises(RuntimeError):
            meshlib.create_mesh()


def test_training_mesh_under_torchrun_without_card_raises(monkeypatch):
    """WORLD_SIZE > 1 and no device asked for means this rank's card: with
    none present it raises before joining a group, as resolve_device(None)
    does, and never trains on the host unasked."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.training_mesh(None)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="gloo"):
        meshlib.initialize_distributed()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_nccl_group_carries_gloo_for_host_tensors(monkeypatch, backend):
    """NCCL runs no collective on host tensors and fetch gathers host
    copies, so an NCCL group is opened with gloo beside it."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("device", d))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: seen.setdefault("backend", b))
    meshlib.initialize_distributed(backend)
    assert seen == {"backend": "cuda:nccl,cpu:gloo",
                    "device": torch.device("cuda", 0)}


def test_training_mesh_reads_the_mesh_config():
    """PipelineConfig.mesh names the axes; training is data-parallel only,
    so a model axis larger than 1 raises."""
    m = meshlib.training_mesh("cpu", MeshConfig(data_axis="batch",
                                                model_axis="tensor"))
    assert m.shape == {"batch": 1, "tensor": 1} and m.n_data == 1
    assert m.devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="data-parallel"):
        meshlib.training_mesh("cpu", MeshConfig(model_parallel_size=2))


def test_local_batch_size():
    mesh = meshlib.create_mesh(["cpu"] * 8)
    assert meshlib.local_batch_size(16, mesh) == 2
    assert meshlib.local_batch_size(16, mesh) == jax_mesh.local_batch_size(
        16, jax_mesh.create_mesh())
    with pytest.raises(ValueError):
        meshlib.local_batch_size(10, mesh)


@pytest.mark.parametrize("n,m", [(5, 4), (8, 4), (1, 8), (0, 2), (9, 1)])
def test_pad_rows_and_local_rows(n, m):
    assert meshlib.pad_rows_to_multiple(n, m) == \
        jax_mesh.pad_rows_to_multiple(n, m)
    # one process: every row is local (the JAX package's process_count 1)
    assert meshlib.local_rows(n) == jax_mesh.local_rows(n) == slice(0, n)


def test_shard_batch_splits_rows_over_devices(rng):
    mesh = meshlib.create_mesh(CPU4)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    stacked = rng.integers(0, 9, size=(3, 8, 2))
    parts = meshlib.shard_batch(mesh, {"x": x, "ids": ["a"] * 8},
                                {"x": torch.float32})
    assert len(parts) == 4 and set(parts[0]) == {"x"}
    np.testing.assert_array_equal(
        torch.cat([p["x"] for p in parts]).numpy(), x)
    # (K, B, ...) micro-batch stacks split on B
    parts = meshlib.shard_batch(mesh, {"s": stacked}, {"s": torch.int64},
                                batch_axis=1)
    assert parts[1]["s"].shape == (3, 2, 2)
    np.testing.assert_array_equal(parts[1]["s"].numpy(), stacked[:, 2:4])
    np.testing.assert_array_equal(meshlib.fetch([p["s"][0] for p in parts]),
                                  stacked[0])
    with pytest.raises(ValueError):
        meshlib.shard_batch(mesh, {"x": x[:6]}, {"x": torch.float32})


def test_device_prefetch_and_threaded_loader(rng):
    batches = [{"x": rng.standard_normal((4, 3)).astype(np.float32),
                "ids": [f"u{i}"] * 4} for i in range(5)]
    got = list(device_prefetch(iter(batches), dtypes={"x": torch.float32},
                               device="cpu"))
    assert [g["ids"] for g in got] == [b["ids"] for b in batches]
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g["x"].numpy(), b["x"])
    sharded = list(device_prefetch(iter(batches), meshlib.create_mesh(
        ["cpu"] * 2), dtypes={"x": torch.float32}))
    assert len(sharded) == 5 and len(sharded[0]) == 2
    np.testing.assert_array_equal(sharded[3][1]["x"].numpy(),
                                  batches[3]["x"][2:])
    assert list(threaded_loader(lambda: iter(range(20)), queue_size=2)) == \
        list(range(20))
    stopped = threaded_loader(lambda: iter(range(100)), queue_size=2)
    assert next(stopped) == 0
    stopped.close()                 # the worker thread ends

    def failing():
        yield 1
        raise OSError("unreadable wav")

    with pytest.raises(OSError, match="unreadable"):
        list(threaded_loader(failing))


def write_tiny_corpus(tmp_path, rng, n=9):
    """test_mesh.py's corpus: 9 samples of one bucket pair."""
    align = tmp_path / "aligner"
    align.mkdir()
    save_symbols(align / "symbols.json", [" ", "a", "b"])
    root = tmp_path / "tte"
    root.mkdir()
    (root / "speakers.json").write_text(json.dumps({"en_f": 0}))
    entries = []
    for i in range(n):
        k = int(rng.integers(3, 8))
        durs = rng.integers(1, 3, size=k)
        entries.append({
            "audio": f"/x/en_f_{i}.wav",
            "characters": " ".join(rng.choice(["a", "b", "sil"], size=k)),
            "hubert": " ".join(map(str, rng.integers(0, 9, size=durs.sum()))),
            "duration": " ".join(map(str, durs)),
            "speaker": "en_f",
        })
    write_manifest(root / "train.txt", entries)
    return root, align


def test_process_slices_are_the_jax_loaders_and_tile_the_batch(tmp_path,
                                                               rng):
    root, align = write_tiny_corpus(tmp_path, rng)
    jds = jax_data.TTEDataset(root, align, "train", hubert_codes=9)
    pds = tte_data.TTEDataset(root, align, "train", hubert_codes=9)

    def port(pi, pc):
        return list(tte_data.BucketedLoader(
            pds, 4, (8,), (16,), seed=7, process_index=pi,
            process_count=pc).batches(epoch=3))

    def jax_host(pi, pc):
        return list(jax_data.BucketedLoader(
            jds, 4, (8,), (16,), seed=7, process_index=pi,
            process_count=pc).batches(epoch=3))

    full = port(0, 1)
    for pi in range(2):
        got, want = port(pi, 2), jax_host(pi, 2)
        assert len(got) == len(want) == len(full)
        for g, w in zip(got, want):
            assert g["ids"] == w["ids"]
            for k in w:
                if k != "ids":
                    np.testing.assert_array_equal(g[k], w[k])
    for b0, b1, bf in zip(port(0, 2), port(1, 2), full):
        assert b0["phones"].shape == (2, 8)
        for k in bf:
            if k != "ids":
                np.testing.assert_array_equal(
                    np.concatenate([b0[k], b1[k]]), bf[k])
    with pytest.raises(ValueError):
        tte_data.BucketedLoader(pds, 5, (8,), (16,), process_count=2)


def test_shard_for_host_matches_jax():
    idx = np.arange(11)
    for pi in range(3):
        np.testing.assert_array_equal(tte_data.shard_for_host(idx, pi, 3),
                                      jax_data.shard_for_host(idx, pi, 3))


def serve_case():
    jcfg, tte, jvcfg, voc = serve_t.jax_weights()
    tcfg, vcfg = serve_t.port_configs()
    rng = np.random.default_rng(9)
    seqs = [rng.integers(2, tcfg.vocab_size, size=n).astype(np.int32)
            for n in (5, 9, 14, 7, 12, 3, 10)]
    samples = [(s, i % tcfg.n_speaker) for i, s in enumerate(seqs)]
    plan = [(16, 64, [0, 1, 2, 3, 4, 5, 6])]
    return jcfg, tte, tcfg, samples, plan


def test_sharded_decode_matches_jax_mesh_and_solo_shards():
    """decode_buckets over 4 CPU devices: the units of the JAX package's
    decode_buckets over its 8-device mesh, and bit-equal to the port's
    solo decode of each shard's rows (7 rows pad to 8: 2 per device)."""
    jcfg, tte, tcfg, samples, plan = serve_case()
    model = parrot.Parrot(tcfg, folded=True)
    model.load_state_dict(fold_tte_params(tte_state_from_jax(tte, tcfg)),
                          strict=True)
    model.eval()
    got = decode_buckets(model, samples, plan, batch_size=8, device="cpu",
                         mesh=meshlib.create_mesh(CPU4))
    infer = jax.jit(jax_parrot.infer_codes,
                    static_argnames=("cfg", "out_len", "exact",
                                     "with_margin"))
    fparams = jax.device_put(jax_fold(tte),
                             jax_mesh.replicated(jax_mesh.create_mesh()))
    want = jax_decode_buckets(infer, fparams, jcfg, samples, plan,
                              batch_size=8, mesh=jax_mesh.create_mesh())
    rows = plan[0][2] + [0]
    for d in range(4):
        shard = rows[2 * d: 2 * d + 2]
        solo = decode_buckets(model, [samples[i] for i in shard],
                              [(16, 64, [0, 1])], batch_size=8,
                              device="cpu")
        for gi, u in zip(shard, solo):
            np.testing.assert_array_equal(got[gi], u)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the hybrid's re-decode runs through the mesh too
    hyb = decode_buckets(model, samples, plan, batch_size=8, device="cpu",
                         exact="hybrid", mesh=meshlib.create_mesh(CPU4))
    assert len(hyb) == 7 and all(len(h) == len(g) for h, g in zip(hyb, got))


def test_sharded_synthesizer_matches_jax_mesh_and_solo_shards(rng):
    """VocoderSynthesizer over 4 CPU devices: bit-equal to the port's
    solo serve of each 2-row shard, within test_torch_vocoder's 2e-5 of
    the JAX package's 8-device mesh serve; int8-static under the mesh
    calibrates once, on the whole bucket, and every replica serves those
    scales."""
    jcfg, tcfg, params, model = voc_t.build()
    state = model.state_dict()
    codes = [rng.integers(0, 40, size=100).astype(np.int32)
             for _ in range(7)]
    spk = [0, 1, 2, 3, 0, 1, 2]
    mesh = meshlib.create_mesh(CPU4)
    got = VocoderSynthesizer(state, tcfg, device="cpu",
                             mesh=mesh).synthesize(codes, spk)
    solo = VocoderSynthesizer(state, tcfg, device="cpu")
    rows = list(range(7)) + [0]
    for d in range(4):
        shard = rows[2 * d: 2 * d + 2]
        for gi, w in zip(shard, solo.synthesize([codes[i] for i in shard],
                                                [spk[i] for i in shard])):
            np.testing.assert_array_equal(got[gi], w)
    jmesh = jax_mesh.create_mesh()
    want = JaxSynthesizer(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                          mesh=jmesh).synthesize(codes, spk)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)

    import dataclasses

    qcfg = dataclasses.replace(tcfg, quant="int8-static")
    sharded = VocoderSynthesizer(state, qcfg, device="cpu",
                                 mesh=meshlib.create_mesh(["cpu"] * 2))
    q = sharded.synthesize(codes[:4], spk[:4])
    whole = VocoderSynthesizer(state, qcfg, device="cpu")
    ref = whole.synthesize(codes[:4], spk[:4])
    assert all(torch.equal(a, b) for a, b in zip(sharded.staticq.scales,
                                                 whole.staticq.scales))
    assert len({id(s) for s in sharded.staticqs}) == 1   # devices repeat
    for a, b in zip(q, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_sharded_parrot_tts_matches_solo():
    """ParrotTTS(mesh=) on 4 CPU devices: the solo serve's units, its
    waveforms within 1e-5, and the same global audio seconds."""
    _, tte, _, voc = serve_t.jax_weights()
    solo = serve_t.port_tts(tte, voc, exact=True)
    sharded = serve_t.port_tts(tte, voc, exact=True,
                               mesh=meshlib.create_mesh(CPU4))
    toks = [solo.tokenize(t) for t in serve_t.TEXTS]
    for a, b in zip(sharded.predict_units(toks, serve_t.SPEAKERS),
                    solo.predict_units(toks, serve_t.SPEAKERS)):
        np.testing.assert_array_equal(a, b)
    want = solo.tts(serve_t.TEXTS, serve_t.SPEAKERS)
    got = sharded.tts(serve_t.TEXTS, serve_t.SPEAKERS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert sharded.last_stats["audio_seconds"] == \
        solo.last_stats["audio_seconds"]


def test_tensor_parallel_rules_cover_the_jax_rules():
    """The port's TTE_RULES shard the tensors the JAX rules shard, on the
    same axis: each JAX leaf is filled with its index along its sharded
    axis (0 where replicated), carried to the port's names and layouts by
    `convert.tte_state_from_jax`, and the port's spec must name exactly
    the axis that varies."""
    from parrot_tts_tpu.core.config import TTEModelConfig as JaxTTEConfig
    from parrot_tts_tpu.core.config import TransformerStackConfig as JaxStack
    from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                                  TransformerStackConfig)

    kw = dict(d_model=16, conv_n_filter=32, conv_kernel_sizes=(9, 1),
              max_len=64, dur_n_filter=8, dur_kernel_size=3, hubert_codes=24,
              n_speaker=4, vocab_size=12, pad_idx=0)
    jcfg = JaxTTEConfig(**kw, encoder=JaxStack(2, 2), decoder=JaxStack(2, 2))
    tcfg = TTEModelConfig(**kw, encoder=TransformerStackConfig(2, 2),
                          decoder=TransformerStackConfig(2, 2))
    params = jax_parrot.init_parrot(jax.random.key(0), jcfg)
    specs = jax_partition_specs(params)

    def marked(leaf, spec):
        a = np.zeros(leaf.shape, np.float32)
        for d, axis in enumerate(spec):
            if axis == "model":
                shape = [1] * a.ndim
                shape[d] = a.shape[d]
                a = a + 1 + np.arange(a.shape[d]).reshape(shape)
        return a

    tree = jax.tree_util.tree_map(marked, params, specs)
    state = tte_state_from_jax(tree, tcfg)
    port_specs = tp.partition_specs(state)
    sharded = 0
    for name, x in state.items():
        varies = tuple(d for d in range(x.dim())
                       if x.shape[d] > 1 and bool(
                           (x.amax(dim=d) != x.amin(dim=d)).any()))
        want = tuple(d for d, a in enumerate(port_specs[name]) if a == "model")
        assert varies == want, (name, varies, port_specs[name])
        sharded += bool(want)
    assert sharded == 4 * 7 + 2   # 7 per FFT block, the head's w and b
    assert port_specs["tok_emb.weight"] == ()
    assert port_specs["encoder_layers.0.attn_norm.weight"] == ()


def test_shard_params_tp_splits_q_k_v_by_heads():
    from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                                  TransformerStackConfig)

    tcfg = TTEModelConfig(d_model=16, conv_n_filter=32, max_len=64,
                          dur_n_filter=8, hubert_codes=24, n_speaker=2,
                          vocab_size=12, pad_idx=0,
                          encoder=TransformerStackConfig(1, 2),
                          decoder=TransformerStackConfig(1, 2))
    state = parrot.init_parrot(tcfg, torch.Generator().manual_seed(0))
    mesh = meshlib.create_mesh(["cpu"] * 2, model_parallel_size=2)
    local = tp.shard_params_tp(mesh, state)
    name = "encoder_layers.0.attention.mha.in_proj_weight"
    q, k, v = state[name].chunk(3)
    assert torch.equal(local[name], torch.cat([q[:8], k[:8], v[:8]]))
    assert local["head.weight"].shape == (12, 16)
    assert local["encoder_layers.0.convlayer.conv2.weight"].shape == (16, 16, 1)
    assert torch.equal(local["tok_emb.weight"], state["tok_emb.weight"])


@pytest.mark.parametrize("folded", [False, True])
def test_shard_parrot_tp_at_model_axis_one_is_the_model(folded):
    """On a model axis of 1 the sharded copy holds the whole tensors and
    the forward with mesh= is the forward without it, bit for bit."""
    from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                                  TransformerStackConfig)

    tcfg = TTEModelConfig(d_model=16, conv_n_filter=32, max_len=64,
                          dur_n_filter=8, hubert_codes=24, n_speaker=2,
                          vocab_size=12, pad_idx=0,
                          encoder=TransformerStackConfig(1, 2),
                          decoder=TransformerStackConfig(1, 2))
    state = parrot.init_parrot(tcfg, torch.Generator().manual_seed(0))
    model = parrot.Parrot(tcfg, folded=folded)
    model.load_state_dict(fold_tte_params(state) if folded else state,
                          strict=True)
    mesh = meshlib.create_mesh(["cpu"])
    local = tp.shard_parrot_tp(mesh, model)
    assert local is not model
    for k, v in model.state_dict().items():
        assert torch.equal(local.state_dict()[k], v)
    rng = np.random.default_rng(0)
    batch = {"phones": rng.integers(1, 12, size=(2, 7)),
             "src_mask": np.arange(7)[None] < np.array([[7], [4]]),
             "speaker": np.array([0, 1])}
    want = parrot.infer_codes(model, batch, out_len=40, device="cpu",
                              with_margin=True)
    got = parrot.infer_codes(local, batch, out_len=40, device="cpu",
                             with_margin=True, mesh=mesh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
