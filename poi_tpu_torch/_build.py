"""Build and load the package's hand-written CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface (``csrc/*.cuh`` are
headers they share). Each is compiled by its own ``nvcc`` process, all
started together, and the objects are linked, with ``libcuda``
(``-lcuda``), into one shared library, loaded with ``ctypes``. The library
lands in ``build/poi_tpu_torch/`` at the
repository root, named by a hash of the sources, headers and flags, so an
edited file rebuilds and an unchanged tree loads the cached library. Nothing is built when the package is imported: the first
kernel launch on a CUDA tensor calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "poi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report registers, shared memory and spills per kernel
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every pointer and the stream go as c_void_p.
_SIGNATURES = {
    "gru_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gru_fwd_cluster_size": [_I],
    "gru_fwd_fits": [_I, _I],
    "gru_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gru_bwd_cluster_size": [_I, _I],
    "gru_bwd_splits": [_I, _I, _I],
    "gru_grid_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "gru_max_hidden": [],
    "gru_fwd_grid": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gru_bwd_grid": [_P] * 10 + [_I, _I, _I, _I, _P],
    "gru_stream_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "gru_fwd_stream": [_P] * 5 + [_I] * 4 + [_P],
    "gru_bwd_stream": [_P] * 11 + [_I] * 4 + [_P],
    "lstm_max_hidden": [],
    "lstm_stream_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "lstm_fwd_stream": [_P] * 7 + [_I] * 4 + [_P],
    "lstm_bwd_stream": [_P] * 14 + [_I] * 4 + [_P],
    "lstm_grid_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "lstm_fwd_grid": [_P] * 7 + [_I, _I, _I, _I, _P],
    "lstm_bwd_grid": [_P] * 13 + [_I, _I, _I, _I, _P],
    "lstm_fwd_cluster_size": [_I],
    "lstm_fwd_fits": [_I, _I],
    "lstm_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "lstm_bwd_splits": [_I, _I, _I],
    "lstm_bwd": [_P] * 10 + [_I, _I, _I, _I, _P],
    "rnn_max_hidden": [],
    "rnn_stream_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "rnn_fwd_stream": [_P] * 6 + [_I] * 4 + [_P],
    "rnn_bwd_stream": [_P] * 12 + [_I] * 4 + [_P],
    "rnn_grid_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "rnn_fwd_grid": [_P] * 6 + [_I, _I, _I, _I, _P],
    "rnn_bwd_grid": [_P] * 11 + [_I, _I, _I, _I, _P],
    "rnn_fwd_cluster_size": [_I, _I],
    "rnn_fwd_group_rows": [_I, _I],
    "rnn_fwd_fits": [_I, _I, _I],
    "rnn_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rnn_bwd_splits": [_I, _I, _I],
    "rnn_bwd_cluster_size": [_I],
    "rnn_bwd_fits": [_I, _I],
    "rnn_bwd": [_P] * 8 + [_I] * 5 + [_P],
    "ce_supports_dim": [_I],
    "ce_lse_plan": [_I, ctypes.POINTER(_I)],
    "ce_bwd_plan": [_I, ctypes.POINTER(_I)],
    "ce_lse_scratch": [_I, _I, _I, _I],
    "ce_lse_variant": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ce_bwd_scratch": [_I, _I, _I],
    "ce_bwd": [_P] * 9 + [_I, _I, _I, _I, _P],
    "sampled_supports_dim": [_I],
    "sampled_plan": [_I, ctypes.POINTER(_I)],
    "sampled_lse_scratch": [_I] * 4,
    "sampled_lse": [_P] * 7 + [_I] * 5 + [_P],
    "sampled_bwd_scratch": [_I] * 5,
    "sampled_bwd": [_P] * 11 + [_I] * 6 + [_P],
    "topk_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "topk_wg_smem": [_I] * 6,
    "topk_wg": [_P] * 9 + [_I] * 12 + [_P],
    "poi_cuda_error_string": [_I],
}
# Entry points that return another type than int.
_RESTYPES = {"poi_cuda_error_string": ctypes.c_char_p, "ce_bwd_scratch": ctypes.c_longlong,
             "sampled_bwd_scratch": ctypes.c_longlong}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda: cannot build the CUDA kernels")


def _libcuda_link_flags(nvcc: str) -> list[str]:
    """``-lcuda`` (ce_bwd.cu encodes its TMA descriptors with libcuda's
    ``cuTensorMapEncodeTiled``), with the toolkit's stub directories on the
    search path for a machine whose libcuda lies elsewhere; the real
    ``libcuda.so.1`` is found when the library is loaded."""
    root = Path(nvcc).resolve().parents[1]
    stubs = [d for d in (root / "lib64" / "stubs", root / "targets" / "x86_64-linux" / "lib" / "stubs") if d.is_dir()]
    return [*(f"-L{d}" for d in stubs), "-lcuda"]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "-lcuda")).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpoi_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns the library's path and nvcc's output (empty when cached). A
    failed build raises with nvcc's stderr.
    """
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = None
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}"
        if failed:
            raise RuntimeError(failed)
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *objs, *_libcuda_link_flags(nvcc)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out, "".join(log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, _I)
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().poi_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
