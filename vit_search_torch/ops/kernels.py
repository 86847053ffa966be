"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds start
together (one ``nvcc`` per source), happen at first use, and land in
``vit_search_torch/csrc/build/`` (listed in ``.gitignore``) under a name that
hashes the source, the ``csrc`` headers it includes and the flags, so an
edited source or header is rebuilt.

Nothing here runs at import time: the CPU tests import every module, and the
CPU has neither ``nvcc`` nor a card.

Every kernel wrapper owns a :class:`Kernel` record whose ``launches`` count
goes up by one where the wrapper launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("attention", "masked_ln", "stats", "attn_lab", "window_attention",
           "batch_norm", "prefix_mask", "attention_rope", "swiglu_ln")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Kernel:
    """One ported TPU kernel: where it lives and how often it launched."""

    name: str
    source: str      # path in the repository
    replaces: str    # file:line of the Pallas kernel it replaces
    launches: int = 0


KERNELS: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc for sm_90a) on PATH or under CUDA_HOME")


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Optional[List[Path]] = None) -> List[Path]:
    """``path`` and every ``csrc`` header it includes, directly or not."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            _sources(CSRC / name.decode(), seen)
    return seen


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    headers it includes and the flags, so an edit to any of them rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(CSRC / f"{name}.cu"):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libvst_{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library, all at once.

    Returns ``{source: ptxas report}`` for the sources built by this call.
    Raises with the compiler's output if any build fails.
    """
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failures = {}, []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
        reports[name] = out
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def num_sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes=(torch.bfloat16, torch.float32),
                      ndim: Optional[int] = None, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted dtype
    whose data starts on an ``align``-byte boundary."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
