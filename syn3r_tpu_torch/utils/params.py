"""Reader of the flat .npz weight files the JAX package writes.

``syn3r_tpu.utils.params.save_params`` stores a flax param tree as one npz
keyed by '/'-joined paths. This reads it back as a nested dict of numpy
arrays, the form ``models.convert.load_flax_params`` takes.
"""

from __future__ import annotations

import numpy as np


def load_params(path) -> dict:
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return {"params": tree}
