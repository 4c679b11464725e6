"""Weight bridge between the packages, seeded init, and the port's import
boundary (it never imports jax or parrot_tts_tpu)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax

from parrot_tts_tpu.core.config import TTEModelConfig as JaxTTEConfig
from parrot_tts_tpu.core.config import TransformerStackConfig as JaxStack
from parrot_tts_tpu.core.config import VocoderModelConfig as JaxVocoderConfig
from parrot_tts_tpu.models.tte import parrot as jax_parrot
from parrot_tts_tpu.models.tte.convert import params_from_torch
from parrot_tts_tpu.models.vocoder import generator as jax_gen
from parrot_tts_tpu.models.vocoder.convert import generator_params_from_torch
from parrot_tts_tpu_torch.convert import (generator_state_from_jax,
                                          tte_state_from_jax)
from parrot_tts_tpu_torch.core.config import (TTEModelConfig,
                                              TransformerStackConfig,
                                              VocoderModelConfig)
from parrot_tts_tpu_torch.models.tte import parrot
from parrot_tts_tpu_torch.models.vocoder import generator as gen

REPO = Path(__file__).resolve().parents[1]
TTE = dict(d_model=16, conv_n_filter=32, max_len=300, dur_n_filter=8,
           hubert_codes=20, n_speaker=2, vocab_size=12)
VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 3), (1, 3, 5)), num_embeddings=20,
           embedding_dim=4, model_in_dim=8, num_speakers=3)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_tte_state_round_trips_through_jax_converter():
    jcfg = JaxTTEConfig(**TTE, encoder=JaxStack(2, 2), decoder=JaxStack(1, 2))
    tcfg = TTEModelConfig(**TTE, encoder=TransformerStackConfig(2, 2),
                          decoder=TransformerStackConfig(1, 2))
    params = jax.jit(jax_parrot.init_parrot, static_argnums=1)(
        jax.random.key(3), jcfg)
    state = tte_state_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    parrot.Parrot(tcfg).load_state_dict(state, strict=True)
    _assert_trees_equal(params_from_torch(state, jcfg), params)


def test_generator_state_round_trips_through_jax_converter():
    for resblock in ("1", "2"):
        jcfg = JaxVocoderConfig(resblock=resblock, **VOC)
        tcfg = VocoderModelConfig(resblock=resblock, **VOC)
        params = jax.jit(jax_gen.init_code_generator, static_argnums=1)(
            jax.random.key(4), jcfg)
        state = generator_state_from_jax(
            jax.tree_util.tree_map(np.asarray, params), tcfg)
        gen.CodeGenerator(tcfg).load_state_dict(state, strict=True)
        _assert_trees_equal(generator_params_from_torch(state, jcfg), params)


def test_seeded_init_loads_and_repeats():
    tcfg = TTEModelConfig(**TTE)
    vcfg = VocoderModelConfig(**VOC)
    a = parrot.init_parrot(tcfg, torch.Generator().manual_seed(7))
    b = parrot.init_parrot(tcfg, torch.Generator().manual_seed(7))
    parrot.Parrot(tcfg).load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not a["tok_emb.weight"][tcfg.pad_idx].any()
    bound = 1 / np.sqrt(TTE["d_model"] * 9)   # kaiming fan-in of conv1
    w = a["encoder_layers.0.convlayer.conv1.weight"]
    assert w.shape == (32, 16, 9) and float(w.abs().max()) <= bound
    g = gen.init_code_generator(vcfg, torch.Generator().manual_seed(7))
    gen.CodeGenerator(vcfg).load_state_dict(g, strict=True)
    assert g["ups.0.weight_g"].shape == (16, 1, 1)       # per Cin, torch dim 0


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import parrot_tts_tpu_torch.infer.serving\n"
        "import parrot_tts_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'parrot_tts_tpu' or m.startswith('parrot_tts_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'parrot_tts_tpu_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
