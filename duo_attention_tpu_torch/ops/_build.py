"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``duo_attention_tpu_torch/build/lib<name>-<hash>.so``. The hash covers the
source, every header of ``csrc/`` it includes (``#include "..."``, followed
through headers), and the flags, so an edited source or header builds anew
and an unchanged one is reused. ``build()`` starts one ``nvcc`` per source, all at once.
A variant is a source built with extra macros (``-D``), to another library,
for measurements that compare two versions of a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("flash", "flash_q4", "gemm", "inplace")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, in the order met."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def _flags(defines: Tuple[str, ...]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def target(name: str, defines: Tuple[str, ...]) -> str:
    """A build's key: the source's name, then "+MACRO" for each define."""
    return name + "".join(f"+{d}" for d in defines)


def build(names: Iterable[str] = SOURCES, variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()
          ) -> Dict[str, Path]:
    """Compile every named source, and every (source, macros) variant, that
    has no current library, in parallel.

    Returns {name (a variant: "name+MACRO"): library path}. Raises
    RuntimeError with the compiler's output if any build fails. The
    compiler's report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: (n, ()) for n in names}
    targets.update({target(n, tuple(d)): (n, tuple(d)) for n, d in variants})
    paths = {t: library_path(n, d) for t, (n, d) in targets.items()}
    procs = {}
    for key, path in paths.items():
        if path.exists():
            continue
        name, defines = targets[key]
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
            continue
        paths[name].with_suffix(".log").write_text(text)
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, signatures: Dict[str, list], defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` (with ``defines``, the
    variant); declare each C entry's argument types. Every entry returns its
    cudaError_t as an int, and every library exports ``error_string`` to
    name it."""
    key = target(name, defines)
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([], [(name, defines)])[key]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.error_string(err).decode()})")
