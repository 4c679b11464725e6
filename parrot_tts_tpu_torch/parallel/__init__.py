"""Parallelism layer.

Port of `parrot_tts_tpu/parallel/__init__.py`: data parallelism (the
reference's only strategy) lives in `core/mesh.py` and is re-exported
here; `parallel.tensor` adds the model-axis partition rules and the
sharded TTE that the model's own forward runs with `mesh=`.
"""

from parrot_tts_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    initialize_distributed,
    local_batch_size,
    replicated,
    shard_batch,
)
from parrot_tts_tpu_torch.parallel.tensor import (  # noqa: F401
    TTE_RULES,
    partition_specs,
    shard_params_tp,
    shard_parrot_tp,
)
