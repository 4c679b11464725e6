"""The yardstick's counts against hand-worked cases."""

import json
import math

import pytest
import torch

from harness import spec, yardstick
from reference import vocoder as ref_vocoder

V1 = json.loads((spec.BENCH / "configs" / "parrot-v1-f32.json")
                .read_text())["vocoder"]
TINY_TTE = {"d_model": 4, "conv_n_filter": 8, "conv_kernel_sizes": [3, 1],
            "encoder": {"n_layer": 1}, "decoder": {"n_layer": 1},
            "dur_n_filter": 4, "dur_kernel_size": 3, "hubert_codes": 5}
TINY_VOC = {"upsample_rates": [2], "upsample_kernel_sizes": [4],
            "upsample_initial_channel": 4, "model_in_dim": 6,
            "resblock": "1", "resblock_kernel_sizes": [3],
            "resblock_dilation_sizes": [[1]]}


def test_attention_counts_each_rows_valid_square_once():
    # rows of 2 and 3 keys, 2 heads of 4: 4 * 2 * (4 + 9) * 4 operations;
    # Q, K, V, O of 4 bytes: 16 * 2 * (2 + 3) * 4 bytes
    assert yardstick.attention_launch([2, 3], 2, 4) == (416.0, 640.0)
    assert yardstick.attention_bound_s([[2, 3], [2, 3]], 2, 4) == \
        2 * 640 / 3.35e12


def test_mrf_counts_two_convs_per_dilation_over_trimmed_samples():
    # 10 samples, 2 channels, one branch of k = 3, one dilation: 2 convs of
    # 3 taps: 2 * 10 * 2^2 * 6 operations; x and out 4 * 2 * 10 * 2 bytes,
    # weights 4 * (6 * 4 + 2 * 2)
    assert yardstick.mrf_stage(10, 2, [3], [[1]], "float32") == (480.0, 272.0)
    assert yardstick.mrf_stage(10, 2, [3], [[1]], "float32", False)[1] == 160


def test_mrf_bound_at_v1():
    assert yardstick.fused_stages(V1) == [(2, 64, 80), (3, 32, 160),
                                          (4, 16, 320)]
    # 10 units: 800 / 1600 / 3200 samples at 64 / 32 / 16 channels, 126
    # taps each: 2 * 126 * (800 * 64^2 + 1600 * 32^2 + 3200 * 16^2)
    # operations, each stage bound by its operations in bf16
    assert yardstick.mrf_bound_s([4, 6], V1, "bfloat16") == pytest.approx(
        1445068800 / 989e12, rel=1e-12)


def test_tte_operations_by_hand():
    # block(n) = proj 2*n*4*16 + attention 4*n^2*4 + convs 2*n*4*8*(3+1);
    # tokens 2, frames 3: 832 + duration 2*2*3*(16+16) + 2*2*4 + 1296
    # + head 2*3*4*5
    assert yardstick.tte_ops(TINY_TTE, 2, 3) == 2648.0


def test_vocoder_operations_by_hand():
    # conv_pre 2*5*6*4*7; the transposed conv 2*5*4*2*4; the MRF over 10
    # samples 2*10*2^2*6; conv_post 2*10*2*7
    assert yardstick.vocoder_ops(TINY_VOC, 5) == 2760.0


def test_receptive_reach_by_hand_and_at_v1():
    # conv_pre 3 codes of 2 samples, the transposed conv's inputs
    # (ceil(1/2) + 1) * 2, the MRF 1 * (1 + 1), conv_post 3
    assert yardstick.receptive_reach(TINY_VOC) == 15
    assert yardstick.receptive_reach(V1) == 6995


def test_receptive_reach_covers_what_later_codes_change():
    """At V1's topology (32 channels), codes appended after the end change
    only the last receptive_reach samples."""
    from harness import weights
    cfg = {**V1, "upsample_initial_channel": 32, "embedding_dim": 16,
           "model_in_dim": 32}
    config = {"tte": {}, "vocoder": cfg, "assumed": {}}
    sd = weights._fill(weights._vocoder_leaves(cfg),
                       torch.Generator().manual_seed(3), "cpu")
    codes = torch.randint(0, 1000, (60,), generator=torch.Generator()
                          .manual_seed(4)).tolist()
    with torch.no_grad():
        a = ref_vocoder.generate(sd, cfg, codes[:40], 1)
        b = ref_vocoder.generate(sd, cfg, codes, 1)[: len(a)]
    reach = yardstick.receptive_reach(cfg)
    assert torch.allclose(a[: len(a) - reach], b[: len(a) - reach],
                          rtol=0, atol=1e-6)
    assert (a - b).abs().max() > 1e-4
    del config


def test_peaks_are_the_data_sheets():
    assert yardstick.PEAK == {"float32": 494.7e12, "bfloat16": 989e12}
    assert yardstick.HBM == 3.35e12
    assert math.isclose(yardstick.bound_s(989e12, 0, "bfloat16"), 1.0)
