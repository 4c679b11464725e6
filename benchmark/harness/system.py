"""The system under test: `parrot_tts_tpu_torch.infer.serving.ParrotTTS`
on the seeded weights, as a configuration file states it. The only module
of the benchmark that imports the port; it imports the port on first use.
"""

import contextlib
import time

import torch

from harness import weights

KERNELS = ("flash_attn_fwd", "fused_mrf")   # rows 1 and 6, the cells' own


def build_kernels() -> None:
    """Build the cells' CUDA kernels together, with the port's own build
    into the checkout's build/kernels (a no-op once built); any other is
    built on its first launch."""
    from parrot_tts_tpu_torch.core import kernels
    kernels.build(*KERNELS)


def _tte_config(cfg: dict):
    from parrot_tts_tpu_torch.core.config import (TransformerStackConfig,
                                                  TTEModelConfig)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    for name in ("encoder", "decoder"):
        kw[name] = TransformerStackConfig(**cfg[name])
    return TTEModelConfig(**kw)


def _vocoder_config(cfg: dict):
    from parrot_tts_tpu_torch.core.config import VocoderModelConfig
    kw = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
              if isinstance(v, list) else v) for k, v in cfg.items()}
    return VocoderModelConfig(**kw)


class UnitTap:
    """Records what the TTE stage hands the vocoder: wraps the serving
    object's `predict_units` (the boundary between the two stages) and
    keeps each call's token sequences and units (references: it copies
    and computes nothing; `plan` works out the decode plans after the
    window). With `annotate` set, each
    call runs inside a profiler annotation ("serve"), and each stage in
    one of its own ("tte", "vocoder"), that the trace names idle gaps by:
    "serve" alone is ParrotTTS.tts outside both stages (tokenizing,
    planning, its statistics)."""

    def __init__(self, tts):
        self.calls: list[dict] = []
        self.annotate = False
        real_tts = tts.tts
        real_units, real_voc = tts.predict_units, tts.vocoder.synthesize

        def serve(*args, **kwargs):
            with self._span("serve"):
                return real_tts(*args, **kwargs)

        def predict_units(token_seqs, speakers, stats=None):
            with self._span("tte"):
                units = real_units(token_seqs, speakers, stats=stats)
            self.calls.append({"tokens": token_seqs, "units": units})
            return units

        def synthesize(*args, **kwargs):
            with self._span("vocoder"):
                return real_voc(*args, **kwargs)

        tts.tts = serve
        tts.predict_units = predict_units
        tts.vocoder.synthesize = synthesize

    def _span(self, name: str):
        if self.annotate:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def pop(self) -> dict:
        return self.calls.pop()


def plan(tts, win) -> None:
    """Each call's decode batches, by ParrotTTS.plan on its token
    sequences, worked out after the window."""
    for c in win.calls:
        c.plan = tts.plan(c.seqs)


def _reference_vocoder(tts, sd: dict, cfg: dict, dtype: str) -> None:
    """The reference's generator at `dtype` in the system's vocoder's
    place (a control): each request at batch one, its own length."""
    from reference import ieee
    from reference import vocoder as ref_vocoder

    def synthesize(codes, speakers, f0=None):
        with ieee():
            return [ref_vocoder.generate(sd, cfg, c, s, getattr(torch, dtype))
                    .cpu().numpy() for c, s in zip(codes, speakers)]
    tts.vocoder.synthesize = synthesize


def build(config: dict, seed: int, device: str = "cuda",
          override: dict | None = None):
    """(ParrotTTS, UnitTap) on the weights of `seed`. override: fields
    of "serving" and "vocoder" to replace, or "reference_vocoder": a
    type the reference's generator serves the waveforms in (the
    controls)."""
    from parrot_tts_tpu_torch.infer.serving import ParrotTTS
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners
    from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

    override = override or {}
    serving = {**config["serving"], **override.get("serving", {})}
    vocoder = {**config["vocoder"], **override.get("vocoder", {})}
    tte_sd, voc_sd = weights.make(config, seed, device)
    tok = DFATokenizer(list(config["assumed"]["characters"]))
    tts = ParrotTTS(tte_sd, _tte_config(config["tte"]), voc_sd,
                    _vocoder_config(vocoder), tok, english_cleaners,
                    exact=serving["decode"], device=device)
    if "reference_vocoder" in override:
        _reference_vocoder(tts, voc_sd, vocoder, override["reference_vocoder"])
    del tte_sd, voc_sd
    return tts, UnitTap(tts)


def synchronize(device: str = "cuda") -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()
