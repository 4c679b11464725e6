"""Host-to-device prefetch and a background loader thread.

Port of `parrot_tts_tpu/data/prefetch.py`. The reference overlaps input
with compute through DataLoader workers (`train.py:127,135`), except the
vocoder, which runs num_workers=0 (`utils/vocoder/train.py:99`). Here
`device_prefetch` starts the pinned, non-blocking copy of batch N+1 (split
over a mesh's devices when one is given) before batch N is handed out,
and `threaded_loader` runs a file-reading batch iterator in a thread.
"""

from __future__ import annotations

import threading
from queue import Empty, Queue
from typing import Any, Callable, Iterator

from parrot_tts_tpu_torch.core import mesh as meshlib
from parrot_tts_tpu_torch.core.device import batch_to_device


def device_prefetch(batch_iter: Iterator[dict], mesh=None,
                    skip_keys: tuple[str, ...] = ("ids", "filenames"),
                    depth: int = 2, batch_axis: int = 0, *, dtypes: dict,
                    device=None) -> Iterator:
    """Yield batches on the device `depth - 1` steps ahead of compute: the
    keys of `dtypes` as tensors of those dtypes, `skip_keys` as the host
    values. Without a mesh, one dict on `device`; with one, a list of
    dicts, one per data-axis device of this process
    (`core/mesh.py::shard_batch`). batch_axis=1 splits stacked (K, B, ...)
    micro-batches on B."""

    def put(batch: dict):
        host = {k: batch[k] for k in skip_keys if k in batch}
        if mesh is None:
            return {**batch_to_device(batch, dtypes, device), **host}
        return [{**part, **host} for part in
                meshlib.shard_batch(mesh, batch, dtypes, batch_axis)]

    buf: list = []
    for batch in batch_iter:
        buf.append(put(batch))
        if len(buf) >= depth:
            yield buf.pop(0)
    yield from buf


def threaded_loader(make_iter: Callable[[], Iterator[Any]],
                    queue_size: int = 4) -> Iterator[Any]:
    """Run a (file-reading) batch iterator in a background thread, at most
    `queue_size` items ahead. An exception in the thread is raised here;
    a consumer that stops early stops the thread."""
    q: Queue = Queue(maxsize=queue_size)
    stop = threading.Event()

    def worker():
        try:
            for item in make_iter():
                q.put(("item", item))
                if stop.is_set():
                    return
            q.put(("end", None))
        except Exception as e:        # handed to the consumer, raised there
            q.put(("error", e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            kind, item = q.get()
            if kind == "end":
                return
            if kind == "error":
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():           # unblock a worker waiting on put
            try:
                q.get(timeout=0.1)
            except Empty:
                pass
