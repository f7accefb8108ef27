"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, on first use, under ``build/repro_torch/<hash>/`` at the
root of the checkout; the hash covers every file in ``csrc/`` and the flags,
so an edit rebuilds.  ``library(name)`` compiles its own source alone (a
training step, which launches only ``split_bf16x3``, waits for no other
kernel's build); ``build_all()`` compiles every source in parallel, one
``nvcc`` each.
The libraries are loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, and every entry point returns ``cudaGetLastError()``.

No ``--use_fast_math``: the secular loop, the ``log``/``exp`` of the Loewner
step and the ``1/delta`` guards need IEEE division and denormals.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one exactly
where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["LAUNCHES", "build_all", "check", "library", "ptrs", "reset_launches", "stream"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cauchy_matmul", "fused_update_f32", "fused_update_f64", "fused_update_bf16",
           "fused_update_f16", "sparse_proj", "secular_newton", "nearfield", "split_bf16x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

LAUNCHES = {"cauchy_matmul": 0, "fused_update": 0, "fused_update_truncated": 0,
            "sparse_project": 0, "secular_solve": 0, "nearfield": 0, "split_bf16x3": 0,
            "repeat_bf16x3": 0}

_P, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "cauchy_matmul": {
        **{f"cauchy_matmul_{t}": ([_P] * 6 + [_I] * 4 + [_P], _I) for t in ("f32", "f64")},
        **{f"cauchy_matmul_planned_{t}": ([_P] * 6 + [_I] * 6 + [_P], _I) for t in ("f32", "f64")},
        "cauchy_plan": ([_I] * 5 + [_P] * 2, _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    **{f"fused_update_{t}": {
        f"fused_update_{t}": ([_P] * 11 + [_I] * 3 + [_D] + [_I] * 3 + [_P], _I),
        f"fused_update_truncated_{t}": ([_P] * 9 + [_I] * 4 + [_D] + [_I] * 2 + [_P], _I),
        "fused_plan": ([_I] * 5 + [_P], _I),
        "fused_full_scratch_elems": ([_I] * 3, _LL),
        "fused_trunc_scratch_elems": ([_I] * 4, _LL),
    } for t in ("f32", "f64", "bf16", "f16")},
    "sparse_proj": {
        **{f"sparse_{kind}_{t}": ([_P] * 6 + [_I] * 6 + [_P], _I)
           for kind in ("project", "walk") for t in ("f32", "f64")},
        "sparse_scratch_ints": ([_I] * 4, _LL),
    },
    "secular_newton": {
        **{f"secular_solve_{t}": ([_P] * 7 + [_I] * 5 + [_P], _I) for t in ("f32", "f64")},
        "secular_plan": ([_I] + [_P] * 2, _I),
    },
    "nearfield": {
        f"nearfield_{t}": ([_P] * 6 + [_I] * 5 + [_P], _I) for t in ("f32", "f64")
    },
    "split_bf16x3": {n: ([_P] * 2 + [_LL] * 4 + [_P], _I) for n in ("split_bf16x3", "repeat_bf16x3")},
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=SOURCES) -> Path:
    """Compile every missing library of ``names`` (all by default) in
    parallel; returns the build directory."""
    out_dir = _build_dir()
    missing = [s for s in names if not (out_dir / f"lib{s}.so").exists()]
    if not missing:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in missing:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,)) / f"lib{name}.so"))
            for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return lib


def ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def stream() -> int:
    """The handle of the current device's current CUDA stream, read without
    building a ``torch.cuda.Stream`` (which costs microseconds of host time a
    call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs and
    a later synchronize would not report it)."""
    if err != 0:
        msg = library("cauchy_matmul").repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
