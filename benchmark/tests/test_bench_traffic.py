"""The traffic generator: deterministic from the seed, the same lengths for
every seed, texts of exactly their length that the system's front end
and the reference's tokenize alike, lengths in the mixes' buckets."""

import json

import pytest

from harness import spec, traffic
from reference import text as ref_text

MIXES = ("bulk", "online", "long")
# the source bucket every request of a mix lands in (ParrotTTS.plan's
# buckets 64 / 128 / 256 / 512)
BUCKETS = {"bulk": (64, 128, 256), "online": (64,), "long": (512,)}


def load(name):
    return json.loads((spec.BENCH / "traffic" / f"{name}.json").read_text())


def requests(mix, seed, n=3):
    if mix["loop"] == "closed":
        return [r for i in range(n) for r in traffic.call(mix, seed, 4, i)]
    return traffic.arrivals(mix, seed, 4, 5.0)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = load(name)
    a, b = requests(mix, 2**31 + 7), requests(mix, 2**31 + 7)
    assert [(r.text, r.speaker, r.due) for r in a] == \
        [(r.text, r.speaker, r.due) for r in b]
    c = requests(mix, 2**31 + 8)
    assert [r.text for r in a] != [r.text for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_lengths(name):
    mix = load(name)
    lens = [sorted(len(r.text) for r in requests(mix, s)) for s in (1, 99)]
    assert lens[0] == lens[1]
    if mix["loop"] == "open":
        gaps = [sorted(round(b.due - a.due, 9) for a, b in
                       zip(requests(mix, s), requests(mix, s)[1:]))
                for s in (1, 99)]
        assert len(gaps[0]) == len(gaps[1])


@pytest.mark.parametrize("name", MIXES)
def test_texts_are_their_length_in_tokens_and_in_their_buckets(name):
    from parrot_tts_tpu_torch.data.tte_data import pick_bucket
    from parrot_tts_tpu_torch.infer.serving import SRC_BUCKETS
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners
    from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

    mix = load(name)
    chars = json.loads((spec.ROOT / "benchmark/configs/parrot-v1-f32.json")
                       .read_text())["assumed"]["characters"]
    tok = DFATokenizer(list(chars))
    lo, hi = mix["chars"]["min"], mix["chars"]["max"]
    for r in requests(mix, 12345):
        assert english_cleaners(r.text) == r.text
        ids = [tok.stoi["sil" if c == " " else c] for c in r.text]
        assert ref_text.tokenize(r.text, chars) == ids
        assert lo <= len(ids) <= hi
        assert pick_bucket(SRC_BUCKETS, len(ids)) in BUCKETS[name]
        assert 0 <= r.speaker < 4


def test_quantile_lengths():
    chars = {"dist": "normal", "mean": 100, "sd": 40, "min": 17, "max": 190}
    ls = traffic.lengths(chars, 256)
    assert min(ls) >= 17 and max(ls) <= 190
    assert abs(sum(ls) / len(ls) - 100) < 2
    assert traffic.lengths({"dist": "uniform", "min": 10, "max": 64}, 55) \
        == list(range(10, 65))


def test_arrivals_keep_the_rate():
    mix = {"rate_per_s": 200, "max_batch": 64,
           "chars": {"dist": "uniform", "min": 10, "max": 64}}
    plain = traffic.arrivals(mix, 5, 4, 10.0)
    assert all(a.due <= b.due for a, b in zip(plain, plain[1:]))
    assert all(0 <= r.due < 10.0 for r in plain)
    assert 1900 <= len(plain) <= 2000


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_lengths_by_speaker(name):
    mix = load(name)
    pairs = [sorted((len(r.text), r.speaker) for r in requests(mix, s))
             for s in (1, 99)]
    assert pairs[0] == pairs[1]
    if mix["loop"] == "closed":
        per = [sum(r.speaker == k for r in traffic.call(mix, 3, 4, 0))
               for k in range(4)]
        assert per == [mix["requests_per_call"] // 4] * 4
