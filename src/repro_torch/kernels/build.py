"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``repro_torch/csrc/<name>.cu`` exposes a plain C function
``<name>_launch`` and compiles on its own into a shared library for
``sm_90a``; no PyTorch header is included, so a build takes seconds. The
library goes into ``repro_torch/kernels/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, so an edited
source builds anew and an unchanged one is reused. Nothing is built when the
module is imported: :func:`library` builds at first use, and :func:`build`
starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("privacy_conv", "dp_release", "flash_attention", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_ptr, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_float)
# the C interface of each source; every pointer and the stream as c_void_p
SIGNATURES = {
    "privacy_conv": (_c_ptr,) * 5 + (_c_int,) * 5 + (_c_float, _c_ptr),
    "dp_release": (_c_ptr,) * 3 + (_c_ll, _c_ll, _c_float, _c_float, _c_ptr),
    "flash_attention": (_c_ptr,) * 4 + (_c_int,) * 8 + (_c_float, _c_ptr),
    "selective_scan": (_c_ptr,) * 7 + (_c_int,) * 6 + (_c_ptr,),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """The toolkit's compiler: ``$CUDA_HOME/bin/nvcc`` (``CUDA_HOME``
    defaults to ``/usr/local/cuda``), else ``nvcc`` on the ``PATH``."""
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _ptxas_summary(log: str) -> dict:
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spill_st = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    spill_ld = [int(m) for m in re.findall(r"(\d+) bytes spill loads", log)]
    return {"registers": max(regs, default=None),
            "spill_store_bytes": sum(spill_st), "spill_load_bytes": sum(spill_ld)}


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that has no library yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "cached",
    "registers", "spill_store_bytes", "spill_load_bytes", "path"}}``
    (compile seconds of each process, and what ``-Xptxas -v`` reported).
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            info[name] = {"seconds": 0.0, "cached": True, "path": str(target)}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
        info[name] = {"seconds": seconds, "cached": False, "path": str(target),
                      **_ptxas_summary(log)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``argtypes``/``restype`` of its ``<name>_launch`` function declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = list(SIGNATURES[name])
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
