"""Convert a Stable Video Diffusion checkpoint to the ``.npz`` weight files.

Counterpart of ``syn3r_tpu/cli/convert_weights.py``. Input: a local
snapshot of ``stabilityai/stable-video-diffusion-img2vid-xt`` laid out as
``unet/``, ``vae/``, ``image_encoder/`` with ``.safetensors`` or ``.bin``
weights. Output: ``unet.npz``, ``vae.npz``, ``clip.npz`` (and ``lpips.npz``
from ``--lpips``, an ``lpips`` VGG state dict), flax trees in the JAX
package's layout, so both packages' ``--svd_weights`` (and
``--lpips_weights``) read them::

    python -m syn3r_tpu_torch.cli.convert_weights --svd_dir <snapshot> \\
        --out_dir <weights>

``.safetensors`` files are parsed here with numpy (the 8-byte header
length, the JSON header, the raw little-endian buffer); F16 and BF16
tensors are widened to float32.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str) -> dict:
    """Every tensor of a ``.safetensors`` file as a numpy array; F16 and
    BF16 (its 16 bits the top of a float32) become float32."""
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n))
        buf = f.read()
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        dtype = np.dtype(_ST_DTYPES[meta["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(buf[begin:end], dtype).reshape(meta["shape"])
        if meta["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif meta["dtype"] == "F16":
            arr = arr.astype(np.float32)
        out[key] = arr.astype(arr.dtype.newbyteorder("="))
    return out


def _load_state_dict(model_dir: str) -> dict:
    """Every ``.safetensors`` file of a directory (preferred), else every
    torch ``.bin``, as one dict of numpy arrays (float32 for the .bin)."""
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st_files:
        sd = {}
        for path in st_files:
            sd.update(read_safetensors(path))
        return sd
    bin_files = sorted(glob.glob(os.path.join(model_dir, "*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no weights in {model_dir}")
    import torch
    sd = {}
    for path in bin_files:
        data = torch.load(path, map_location="cpu", weights_only=True)
        sd.update({k: v.float().numpy() for k, v in data.items()})
    return sd


def main(argv=None):
    p = argparse.ArgumentParser("syn3r-tpu-torch convert-weights")
    p.add_argument("--svd_dir", required=True,
                   help="local stable-video-diffusion-img2vid-xt snapshot")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--lpips", default=None,
                   help="optional torch lpips(net='vgg') state dict (.pth)")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    from ..models.clip import convert_clip_torch
    from ..models.convert import torch_to_flax
    from ..utils.params import save_params

    for sub, converter, out in (
            ("unet", torch_to_flax, "unet.npz"),
            ("vae", torch_to_flax, "vae.npz"),
            ("image_encoder", convert_clip_torch, "clip.npz")):
        sd = _load_state_dict(os.path.join(args.svd_dir, sub))
        path = os.path.join(args.out_dir, out)
        save_params({"params": converter(sd)}, path)
        print(f"[convert] {sub}: {len(sd)} tensors -> {path}")

    if args.lpips:
        import torch

        from ..models.lpips import convert_lpips_torch
        sd = torch.load(args.lpips, map_location="cpu", weights_only=True)
        sd = {k: v.float().numpy() for k, v in sd.items()}
        save_params({"params": convert_lpips_torch(sd)},
                    os.path.join(args.out_dir, "lpips.npz"))
        print("[convert] lpips -> lpips.npz")


if __name__ == "__main__":
    main()
