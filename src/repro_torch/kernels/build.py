"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``repro_torch/csrc/<name>.cu`` exposes plain C functions
(:data:`SIGNATURES`) and compiles on its own into a shared library for
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
# the C interface of each source, by function; every pointer and the stream
# as c_void_p. The serving kernels' ``<name>_launch_plan_typed`` takes the
# element type as an int (0 float32, 1 bfloat16, 2 float16); their
# ``<name>_launch_plan`` is its float32 case. The LM kernels' entry point ``<name>_launch`` makes its own
# tile or lane choice, which ``flash_attention_launch_tiles`` and
# ``selective_scan_launch_lanes`` take as an argument, so that it can be
# timed against another. The serving kernels' ``<name>_launch_plan`` takes
# the plan that their wrappers choose (``conv_plan``, ``release_plan``).
SIGNATURES = {
    "privacy_conv": {"privacy_conv_launch_plan": (_c_ptr,) * 5 + (_c_int,) * 5
                     + (_c_float, _c_int, _c_int, _c_int, _c_ptr),
                     "privacy_conv_launch_plan_typed": (_c_ptr,) * 5 + (_c_int,) * 5
                     + (_c_float, _c_int, _c_int, _c_int, _c_int, _c_ptr),
                     "privacy_conv_banked_launch_plan": (_c_ptr,) * 6 + (_c_int,) * 7
                     + (_c_float, _c_int, _c_int, _c_int, _c_ptr)},
    "dp_release": {"dp_release_launch_plan": (_c_ptr,) * 4 + (_c_ll, _c_ll, _c_float, _c_float,
                                                              _c_int, _c_ll, _c_int, _c_ptr),
                   "dp_release_launch_plan_typed": (_c_ptr,) * 4 + (
                       _c_ll, _c_ll, _c_float, _c_float, _c_int, _c_ll, _c_int, _c_int,
                       _c_ptr)},
    "flash_attention": {
        "flash_attention_launch": (_c_ptr,) * 4 + (_c_int,) * 8 + (_c_float, _c_ptr),
        "flash_attention_launch_tiles": (_c_ptr,) * 4 + (_c_int,) * 8 + (_c_float, _c_int,
                                                                          _c_ptr)},
    "selective_scan": {
        "selective_scan_launch": (_c_ptr,) * 7 + (_c_int,) * 6 + (_c_ptr,),
        "selective_scan_launch_lanes": (_c_ptr,) * 7 + (_c_int,) * 7 + (_c_ptr,)},
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


def _tool(name: str):
    """A program of the CUDA toolkit (``cu++filt``, ``cuobjdump``), or None."""
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return path if os.path.exists(path) else shutil.which(name)


def _demangle(names: Iterable[str]) -> Dict[str, str]:
    """Mangled kernel names as ``kernel<args>`` (no return type, namespace
    or parameters), where a demangler is at hand."""
    names = list(names)
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return {n: n for n in names}
    # "void <unnamed>::kernel<(int)64, (bool)1>(const float *, ...)" -> "kernel<64, 1>"
    short = (re.sub(r"\((?:unsigned )?(?:int|long|bool)\)|\(anonymous namespace\)::|<unnamed>::",
                    "", o).split("(")[0].removeprefix("void ") for o in out)
    return dict(zip(names, short))


def _ptxas_summary(log: str) -> dict:
    """The most registers of any kernel and the spills of all, and the same
    for each kernel (``functions``, by demangled name), from ``-Xptxas -v``."""
    per = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        fname = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        st = re.search(r"(\d+) bytes spill stores", chunk)
        ld = re.search(r"(\d+) bytes spill loads", chunk)
        per[fname] = {"registers": int(regs.group(1)) if regs else None,
                      "spill_store_bytes": int(st.group(1)) if st else 0,
                      "spill_load_bytes": int(ld.group(1)) if ld else 0}
    names = _demangle(per)
    return {"registers": max((f["registers"] or 0 for f in per.values()), default=None),
            "spill_store_bytes": sum(f["spill_store_bytes"] for f in per.values()),
            "spill_load_bytes": sum(f["spill_load_bytes"] for f in per.values()),
            "functions": {names[n]: f for n, f in per.items()}}


def sass_counts(name: str, opcode: str):
    """``{kernel: number of SASS instructions with that opcode, any
    modifiers}`` in the built library of ``name`` (demangled kernel names), from
    ``cuobjdump -sass``; None where the toolkit has no ``cuobjdump``."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(_target(name))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: Dict[str, int] = {}
    fname = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fname = m.group(1)
            counts[fname] = 0
        elif fname is not None and re.search(rf"\*/\s+(?:@!?U?P\w+\s+)?{opcode}\b", line):
            counts[fname] += 1
    names = _demangle(counts)
    return {names[n]: c for n, c in counts.items()}


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that has no library yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "cached",
    "registers", "spill_store_bytes", "spill_load_bytes", "functions",
    "path"}}`` (compile seconds of each process, and what ``-Xptxas -v``
    reported, in all and for each kernel).
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
    ``argtypes``/``restype`` of its C functions declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fname, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
