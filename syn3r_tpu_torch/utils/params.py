"""The flat .npz weight files of both packages.

A flax param tree is stored as one npz keyed by '/'-joined paths
(``save_params``, as ``syn3r_tpu.utils.params.save_params`` writes it);
``load_params`` reads it back as a nested dict of numpy arrays, the form
``models.convert.load_flax_params`` takes.
"""

from __future__ import annotations

import numpy as np


def save_params(params: dict, path) -> None:
    """A nested dict of arrays (optionally under "params") as one npz."""
    flat = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = np.asarray(v)

    walk(params.get("params", params))
    np.savez(path, **flat)


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
