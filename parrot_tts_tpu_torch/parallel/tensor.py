"""Tensor-parallel partition rules for the `model` mesh axis, and the TTE
forward they shard.

Port of `parrot_tts_tpu/parallel/tensor.py`. The reference has no tensor
parallelism (its models are ~15M parameters); the JAX package keeps the
rules so a larger-than-memory configuration could shard. Rules are
(name regex, spec) pairs over a `Parrot` state dict, in torch layouts
(Linear (out, in), Conv1d (out, in, k)); a spec names the mesh axis of
each dim, unmatched tensors replicate (spec ()). The same tensors are
partitioned as in the JAX rules (`tensor.py:27-42` there), the Megatron
split:

- attention: the packed qkv and in-projection column-parallel (output
  features; each of q, k and v split by heads), the out-projection and
  wo row-parallel (input features);
- FFN: conv1 on its filters (weight and bias), conv2 on its input
  channels;
- the 1000-way head column-parallel (vocabulary-sharded logits).

Under GSPMD the JAX rules only place memory and XLA derives the
collectives. Here they are explicit, on a process group whose ranks form
the model axis (`core/mesh.py::create_mesh(model_parallel_size=n)`, one
device per rank): `shard_parrot_tp` gives each rank a `Parrot` holding
its shards, and the model's own forward (`parrot.apply_parrot`,
`apply_parrot_train` without dropout, `infer_codes`, each with `mesh=`)
runs attention on the rank's heads (row 1, `ops/flash_attention.py`);
one all-reduce follows the out-projection (and, unfolded, a gather of
qkv's output before the in-projection and a second all-reduce after wo),
one follows conv2, each bias is added once, and the head's logits are
gathered before the argmax (`models/tte/fft.py`). Forward and serving
decode only, as the JAX package tests it; tensor-parallel training is
not in either package.
"""

from __future__ import annotations

import copy
import re
from typing import Sequence

import torch
from torch import nn

from parrot_tts_tpu_torch.core.mesh import MODEL_AXIS, Mesh
from parrot_tts_tpu_torch.models.tte.parrot import Parrot

M = MODEL_AXIS
TTE_RULES: tuple[tuple[str, tuple], ...] = (
    # attention: column-parallel packed projections, row-parallel outputs
    (r".*\.attention\.qkv\.weight$", (M, None)),
    (r".*\.attention\.mha\.in_proj_weight$", (M, None)),
    (r".*\.attention\.mha\.out_proj\.weight$", (None, M)),
    (r".*\.attention\.wo\.weight$", (None, M)),
    # conv FFN: up-projection sharded on filters, down-projection on input
    (r".*layers\.\d+\.convlayer\.conv1\.weight$", (M, None, None)),
    (r".*layers\.\d+\.convlayer\.conv1\.bias$", (M,)),
    (r".*layers\.\d+\.convlayer\.conv2\.weight$", (None, M, None)),
    # 1000-way head: column-parallel (vocab-sharded logits)
    (r"^head\.weight$", (M, None)),
    (r"^head\.bias$", (M,)),
)
# packed [q; k; v] rows: each third splits by heads
_PACKED = re.compile(r".*\.attention\.(qkv\.weight|mha\.in_proj_weight)$")


def partition_specs(state: dict, rules: Sequence[tuple[str, tuple]] = TTE_RULES
                    ) -> dict[str, tuple]:
    """Each tensor's spec: the first matching rule's, else () (replicate)."""
    def spec_for(name: str) -> tuple:
        for pat, spec in rules:
            if re.match(pat, name):
                return spec
        return ()

    return {name: spec_for(name) for name in state}


def _shard(name: str, x: torch.Tensor, spec: tuple, rank: int, n: int
           ) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis != M:
            continue
        parts = 3 if _PACKED.match(name) else 1
        size = x.shape[dim] // parts
        if size % n:
            raise ValueError(f"{name}: dim {dim} ({size} per part) does not "
                             f"split over {n}")
        w = size // n
        x = torch.cat([x.narrow(dim, p * size + rank * w, w)
                       for p in range(parts)], dim=dim)
    return x.contiguous()


def shard_params_tp(mesh: Mesh, state: dict,
                    rules: Sequence[tuple[str, tuple]] = TTE_RULES) -> dict:
    """This rank's tensors of a state dict under the rules: its slice on
    the model axis where a rule matches, the whole tensor elsewhere, on
    the mesh's device."""
    specs = partition_specs(state, rules)
    dev = mesh.devices[0]
    return {k: _shard(k, v, specs[k], mesh.model_rank, mesh.n_model).to(dev)
            for k, v in state.items()}


def shard_parrot_tp(mesh: Mesh, model: Parrot,
                    rules: Sequence[tuple[str, tuple]] = TTE_RULES) -> Parrot:
    """A copy of `model` (unfolded or folded) that holds this rank's
    tensors under the rules (`shard_params_tp`), on the mesh's device: the
    model to run with `mesh=` (module docstring)."""
    local = copy.deepcopy(model)
    for name, x in shard_params_tp(mesh, model.state_dict(), rules).items():
        owner, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(owner), leaf, nn.Parameter(x))
    return local.to(mesh.devices[0])
