"""One rank of `tests/test_torch_distributed.py`'s process group.

Run as `python -m tests.torch_dist_worker <spec> <rank> <world> <store>`:
joins a gloo group on the CPU through the `file://` store, reads the
parent's inputs (`spec`, a torch.save'd dict: configs, state dicts, numpy
batches), runs the port's data-parallel TTE and GAN steps, its sharded
serving and the tensor-parallel TTE forward, and writes what it got to
`<spec>.<rank>`. It imports torch, numpy and the port alone: the parent
holds the JAX side.
"""

from __future__ import annotations

import sys
from unittest import mock

import numpy as np
import torch


def _tte(spec: dict, mesh, meshlib) -> dict:
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.ops import flash_dropout as fd
    from parrot_tts_tpu_torch.train import tte as train

    out = {}
    batch = spec["tte_batch"]
    local = {k: v[meshlib.local_rows(len(batch["codes"]))]
             for k, v in batch.items()}
    for key, (tcfg, train_cfg) in spec["tte_cfgs"].items():
        state = train.init_state(0, tcfg, "cpu")
        state.model.load_state_dict(spec["tte_state"], strict=True)
        masks, drops = record_dropout(fd, parrot)
        with masks, drops:
            m1 = train.train_step(state, train.to_batch(local, "cpu"),
                                  spec["run_seed"], tcfg, train_cfg,
                                  spec["out_len"], mesh)
            grad = {k: v.clone() for k, v in state.acc.items()}
            m2 = train.train_step(state, train.to_batch(local, "cpu"),
                                  spec["run_seed"], tcfg, train_cfg,
                                  spec["out_len"], mesh)
        out[key] = {"losses": [float(m["total_loss"]) for m in (m1, m2)],
                    "grad": grad, "params": state.model.state_dict(),
                    "state": state.state_dict(), "masks": masks.seen,
                    "drops": drops.seen}
    return out


class _Record:
    """Patch a function with a wrapper that keeps what `keep` makes of
    each call's arguments and result."""

    def __init__(self, module, name, keep):
        real = getattr(module, name)
        self.seen: list = []

        def spy(*args, **kwargs):
            res = real(*args, **kwargs)
            self.seen.append(keep(res, *args, **kwargs))
            return res

        self.patch = mock.patch.object(module, name, spy)

    def __enter__(self):
        self.patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self.patch.__exit__(*exc)


def record_dropout(fd, parrot):
    """Spies on the attention keep masks (`keep_mask_reference`, forward
    and backward) and the duration predictor's dropout (the zeros of its
    output)."""
    return (_Record(fd, "keep_mask_reference", lambda res, *a, **k: res),
            _Record(parrot, "_dropout", lambda res, *a, **k: res == 0))


def _gan(spec: dict, mesh, meshlib) -> dict:
    from parrot_tts_tpu_torch.train import vocoder as voc_train

    mcfg, tcfg, mel_cfg = spec["gan_cfgs"]
    state = voc_train.init_state(0, mcfg, "cpu")
    state.load_state_dict(spec["gan_state"])
    batch = spec["gan_batch"]
    local = {k: v[meshlib.local_rows(len(batch["code"]))]
             for k, v in batch.items()}
    metrics = voc_train.train_step(state, voc_train.to_batch(local, "cpu"),
                                   mcfg, tcfg, mel_cfg, spec["gan_spe"],
                                   mesh=mesh)
    return {"state": state.state_dict(),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _serve(spec: dict, mesh) -> dict:
    from parrot_tts_tpu_torch.infer.serving import ParrotTTS
    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
    from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners
    from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

    tcfg, vcfg = spec["serve_cfgs"]
    model = parrot.Parrot(tcfg, folded=True)
    model.load_state_dict(spec["serve_tte_folded"], strict=True)
    codes = decode_buckets(model.eval(), spec["samples"], spec["plan"],
                           batch_size=spec["batch_size"], device="cpu",
                           mesh=mesh)
    synth = VocoderSynthesizer(spec["serve_voc"], vcfg, device="cpu",
                               mesh=mesh)
    wavs = synth.synthesize(spec["voc_codes"], spec["voc_speakers"])
    tts = ParrotTTS(spec["serve_tte"], tcfg, spec["serve_voc"], vcfg,
                    DFATokenizer(spec["symbols"]), english_cleaners,
                    src_buckets=spec["src_buckets"], exact=True,
                    device="cpu", mesh=mesh)
    tts_wavs = tts.tts(spec["texts"], spec["speakers"])
    return {"codes": codes, "wavs": wavs, "tts": tts_wavs,
            "audio_seconds": tts.last_stats["audio_seconds"]}


def _tensor_parallel(spec: dict, meshlib) -> dict:
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.models.tte.fold import fold_tte_params
    from parrot_tts_tpu_torch.parallel import tensor as tp

    tcfg = spec["tp_cfg"]
    mesh = meshlib.create_mesh(["cpu"], model_parallel_size=2)
    batch = spec["tp_batch"]
    full = {**parrot.to_batch(batch, "cpu"),
            "duration": torch.as_tensor(batch["duration"], dtype=torch.int64),
            "tgt_mask": torch.as_tensor(batch["tgt_mask"])}
    model = parrot.Parrot(tcfg)
    model.load_state_dict(spec["tp_state"], strict=True)
    local = tp.shard_parrot_tp(mesh, model.eval())
    with torch.no_grad():
        logits, _, log_dur = parrot.apply_parrot_train(
            local, full, out_len=spec["out_len"], mesh=mesh)
    folded = parrot.Parrot(tcfg, folded=True)
    folded.load_state_dict(fold_tte_params(spec["tp_state"]), strict=True)
    codes, mask, total = parrot.infer_codes(
        tp.shard_parrot_tp(mesh, folded.eval()), batch,
        out_len=spec["out_len"], device="cpu", mesh=mesh)
    return {"logits": logits, "log_dur": log_dur, "codes": codes,
            "mask": mask, "total": total,
            "head_rows": local.head.weight.shape[0]}


def main(spec_path: str, rank: int, world: int, store: str) -> None:
    torch.set_num_threads(2)
    from parrot_tts_tpu_torch.core import mesh as meshlib

    meshlib.initialize_distributed("gloo", init_method=store,
                                   world_size=world, rank=rank,
                                   timeout_s=120)
    spec = torch.load(spec_path, weights_only=False)
    mesh = meshlib.create_mesh(["cpu"])
    out = {"rank": meshlib.process_index(), "world": meshlib.process_count(),
           "n_data": mesh.n_data,
           "tte": _tte(spec, mesh, meshlib),
           "gan": _gan(spec, mesh, meshlib),
           "serve": _serve(spec, mesh),
           "tp": _tensor_parallel(spec, meshlib)}
    torch.save(out, f"{spec_path}.{rank}")
    meshlib.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
