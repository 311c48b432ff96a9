"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
``build/syn3r_tpu_torch/`` at the root of the checkout, named by a hash of
every source in ``csrc/`` and the compiler flags; a changed source builds
anew. ``build_all`` starts one nvcc per source, all at once. Nothing is
built at import time: a wrapper builds its library at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "syn3r_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry points and their argument types, per kernel library.
SIGNATURES = {
    # x, w1, b1, w2, b2, h, y; rows, C, inner; GEMM-2 N tile, grids;
    # stream
    "geglu_ffn": {"syn3r_geglu_ffn":
                  [_P] * 7 + [_LL, _I, _I, _I, _I, _I, _P]},
    # q, k, v, o, lse (or null); 3 x 12 map values; B, H, S; o strides;
    # scale; grid; stream
    "flash_attention": {"syn3r_flash_attention":
                        [_P] * 5 + [ctypes.POINTER(_LL), _I, _I, _I, _LL,
                                    _LL, _LL, _F, _I, _P]},
    # q, k, v, o; 3 x 12 map values; B, H, S; o strides; scale; grid;
    # stream
    "frame_attention": {"syn3r_frame_attention":
                        [_P] * 4 + [ctypes.POINTER(_LL), _I, _I, _I, _LL,
                                    _LL, _LL, _F, _I, _P]},
    "flash_attention_bwd": {
        # q, k, v, dout, lse, D, dk, dv; 4 x 12 map values; dk and dv
        # (sb, sh, ss); B, H, S, ld; scale; grid; stream
        "syn3r_flash_bwd_dkv": [_P] * 8 + [ctypes.POINTER(_LL)] * 2
        + [_I] * 4 + [_F, _I, _P],
        # q, k, v, dout, out, lse, D (written), dq; 5 x 12 map values; dq
        # (sb, sh, ss); B, H, S, ld; scale; grid; stream
        "syn3r_flash_bwd_dq": [_P] * 8 + [ctypes.POINTER(_LL)] * 2
        + [_I] * 4 + [_F, _I, _P]},
    # P, G, C, O, out, ltc, keep (or null); T, px, cap, K; stream
    "composite_fwd": {"syn3r_composite_fwd": [_P] * 7 + [_I] * 4 + [_P]},
    # P, G, C, O, ltc, dout, tot, keep, part, dG, dC, dO; T, px, cap, K;
    # stream
    "composite_bwd": {"syn3r_composite_bwd": [_P] * 12 + [_I] * 4 + [_P]},
    "group_norm": {
        # x, weight, bias, part, arrivals, a, b; B, S, C, G; eps; x bf16,
        # weight bf16, threads, grid; stream
        "syn3r_gn_stats": [_P] * 7 + [_I, _LL, _I, _I, _F, _I, _I, _I, _I,
                                      _P],
        # x, part, arrivals, s1, s2; B, S, C; bf16, threads, grid; stream
        "syn3r_gn_sums": [_P] * 5 + [_I, _LL, _I, _I, _I, _I, _P],
        # x, a, b, y; B, S, C; silu, bf16, threads, grid; stream
        "syn3r_gn_apply": [_P] * 4 + [_I, _LL, _I, _I, _I, _I, _I, _P],
        # kernel (0 stats, 1 apply), x bf16, variant, threads
        "syn3r_gn_blocks_per_sm": [_I] * 4},
    # x, weight, bias, y; R, C; eps; x bf16, weight bf16, lanes a row,
    # vectors a lane, grid; stream
    "layer_norm": {"syn3r_layer_norm":
                   [_P] * 4 + [_LL, _I, _F, _I, _I, _I, _I, _I, _P]},
    "project": {
        # means, quats, log_scales, opacity_logits, sh_dc, sh_rest, active,
        # offset (or null), w2c, K, center, conic, rgb, depth, opacity,
        # radius, valid; N, sh_rest row, degree; 0.65 W, 0.65 H, near;
        # stream
        "syn3r_project_fwd": [_P] * 17 + [_I, _I, _I, _F, _F, _F, _P],
        # the six parameters, active, w2c, K; the gradients of center,
        # conic, rgb, depth, opacity (each or null); those of the six
        # parameters; N, sh_rest row, degree; 0.65 W, 0.65 H, near; stream
        "syn3r_project_bwd": [_P] * 20 + [_I, _I, _I, _F, _F, _F, _P]},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all started together. Returns {name: compiler log} (ptxas
    registers, shared memory and spills) for what was built; raises with
    the compiler's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def entry(name: str, fn_name: str | None = None):
    """A C entry point of kernel library ``name``: ``fn_name``, or the
    library's only one."""
    if fn_name is None:
        (fn_name,) = SIGNATURES[name]
    return getattr(library(name), fn_name)
