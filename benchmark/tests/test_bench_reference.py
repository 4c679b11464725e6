"""The plain reference against the system under test at a tiny width on
the CPU: the TTE's durations and logits, the vocoder's waveform in
float32 and in bf16 at the configuration's rounding points."""

import numpy as np
import pytest
import torch

from conftest import tiny
from harness import system, weights
from reference import ieee
from reference import text as ref_text
from reference import tte as ref_tte
from reference import vocoder as ref_vocoder

TEXTS = ["the night was long, and the city slept.",
         "why did they go",
         "several members of the public asked about the law?"]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_tte_matches_the_port(seed):
    from parrot_tts_tpu_torch.infer.tte_infer import make_batch
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.models.tte.fold import fold_tte_params
    from parrot_tts_tpu_torch.ops import length_regulator as lr

    config = tiny("f32.bulk").config
    sd, _ = weights.make(config, seed, "cpu")
    model = parrot.Parrot(system._tte_config(config["tte"]), folded=True)
    model.load_state_dict(fold_tte_params(sd))
    model.eval()
    chars = config["assumed"]["characters"]
    toks = [np.asarray(ref_text.tokenize(t, chars)) for t in TEXTS]
    batch = parrot.to_batch(make_batch([(t, i) for i, t in enumerate(toks)],
                                       [0, 1, 2], 64), "cpu")
    with torch.no_grad():
        logits, mask, log_dur = parrot.apply_parrot(model, batch, out_len=1024)
        dur = torch.where(batch["src_mask"],
                          lr.durations_from_log_pred(log_dur), 0)
    with ieee():
        for i, t in enumerate(toks):
            enc, ld = ref_tte.encode(sd, config["tte"], t.tolist(), i)
            torch.testing.assert_close(ld, log_dur[i, : len(t)], rtol=0,
                                       atol=1e-4)
            d = ref_tte.durations(ld)
            assert torch.equal(d, dur[i, : len(t)].long())
            ref = ref_tte.decode(sd, config["tte"], enc, d)
            got = logits[i][mask[i]]
            assert got.shape == ref.shape
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("workload,fused", [("f32.bulk", True),
                                            ("f32.bulk", False),
                                            ("bf16.bulk", True),
                                            ("bf16.bulk", False)])
def test_vocoder_matches_the_port(workload, fused):
    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer

    config = tiny(workload).config
    vcfg = {**config["vocoder"], "fused_mrf": fused}
    _, sd = weights.make(config, 5, "cpu")
    codes = np.random.default_rng(1).integers(0, 1000, 128)
    port = VocoderSynthesizer(sd, system._vocoder_config(vcfg), exact=True,
                              device="cpu").synthesize([codes], [2])[0]
    dtype = getattr(torch, config["correct"]["reference_dtype"])
    with ieee():
        ref = ref_vocoder.generate(sd, vcfg, codes, 2, dtype).numpy()
        f32 = ref_vocoder.generate(sd, vcfg, codes, 2).numpy()
    assert port.shape == ref.shape == (128 * 320,)

    def err(y):
        return np.linalg.norm(port - y) / np.linalg.norm(y)

    if dtype == torch.float32:
        assert err(ref) < 1e-6
    else:
        # the configuration's bf16 rounding points, not float32's
        assert err(ref) < 1e-6 < 1e-4 < err(f32)
