"""Offline data: the port's counterpart of `ray_tpu/rllib/offline.py`'s
`as_sample_batch` (reference: rllib/offline/ readers feeding SampleBatches).

A SampleBatch or a dict of arrays is taken as it is. A dataset is taken by
duck typing, as JAX's `BC._to_arrays` takes one: any object with
`take_batch` and `count` (a `ray_tpu.data.Dataset`, which the port does
not import) is read whole as numpy columns. Columns that
`sample_batch_to_dataset` flattened for arrow get back the shapes the
dataset advertises in `_offline_shapes`, and every column becomes float32, as
JAX's `dataset_to_sample_batch` makes them.
"""

from typing import Union

import numpy as np

from .sample_batch import SampleBatch


def as_sample_batch(data: Union[SampleBatch, dict, object]) -> SampleBatch:
    """Accept SampleBatch | dict of arrays | dataset (an object with
    `take_batch`)."""
    if isinstance(data, SampleBatch):
        return data
    if isinstance(data, dict):
        return SampleBatch({k: np.asarray(v) for k, v in data.items()})
    if hasattr(data, "take_batch"):
        shapes = getattr(data, "_offline_shapes", {})
        out = SampleBatch()
        for k, v in data.take_batch(data.count(), batch_format="numpy").items():
            v = np.asarray(v.tolist() if v.dtype == object else v, np.float32)
            if shapes.get(k):
                v = v.reshape((len(v),) + tuple(shapes[k]))
            out[k] = v
        return out
    raise TypeError(f"unsupported offline data {type(data)!r}")
