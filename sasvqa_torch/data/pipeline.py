"""Host batch grouping for the train step (counterpart of part of
sasvqa_tpu/data/pipeline.py: ``stack_microbatches``).  The device
prefetcher is not ported yet."""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np

# batch keys that stay host-side lists (per-example ids, group sizes)
HOST_KEYS = ("question_ids", "n_examples_list")


def stack_microbatches(it: Iterator[Dict[str, Any]], k: int,
                       host_keys=HOST_KEYS) -> Iterator[Dict[str, Any]]:
    """Group K consecutive host batches into one stacked batch with a
    leading micro axis, for ``train.steps.make_scan_train_step``: array
    leaves become (K, B, ...), host keys become lists of per-micro
    values, and a leaf that is None must be None in every micro.  All K
    micros must share leaf shapes (fixed collator buckets, drop_last
    batching); an incomplete trailing group is dropped."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    it = iter(it)
    while True:
        group = []
        for _ in range(k):
            try:
                group.append(next(it))
            except StopIteration:
                return
        out: Dict[str, Any] = {}
        for key in group[0]:
            vals = [g[key] for g in group]
            if key in host_keys:
                out[key] = vals
            elif vals[0] is None:
                if any(v is not None for v in vals):
                    raise ValueError(f"leaf {key!r} is None in only some "
                                     f"micro-batches")
                out[key] = None
            else:
                shapes = {np.asarray(v).shape for v in vals}
                if len(shapes) != 1:
                    raise ValueError(
                        f"micro-batch leaf {key!r} shapes differ across the "
                        f"accumulation window: {shapes}")
                out[key] = np.stack(vals)
        yield out
