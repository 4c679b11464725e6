"""Length buckets; a copy of `pick_bucket` from
`parrot_tts_tpu/data/tte_data.py`."""

from __future__ import annotations

import bisect


def pick_bucket(buckets: tuple[int, ...], length: int) -> int:
    """Smallest bucket >= length (the largest bucket caps/crops)."""
    i = bisect.bisect_left(buckets, length)
    return buckets[min(i, len(buckets) - 1)]
