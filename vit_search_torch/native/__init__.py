"""Native (C++) search runtime: cost model + evolutionary operators.

Port of the JAX package's ``native`` module over a copy of its C++ source
(``vitsearch_native.cpp``, only the comments differ): under one seed the
three operators draw the JAX package's native candidates.

The shared library is built with g++ at first use, into ``native/build/``
(listed in ``.gitignore``) under a name that hashes the source, the compiler
and its flags. Each build writes a temporary file of its own and moves it
onto that name with ``os.replace``, so processes that build at once never
load a half-written library. ``available()`` is False when g++ or the build
fails; :class:`NativeSearchOps` then raises with the build's error, and
callers take the pure-Python generators in ``search.generators``.

Encodings are documented in vitsearch_native.cpp; this module owns the
Python<->flat-int64 conversion.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..arch import network_def as nd

_FIELDS = 6
_MAX_TRIES = 1_000_000

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vitsearch_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_CXX = "g++"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _lib_path() -> str:
    """The library's path, named by a hash of the source, compiler and flags."""
    h = hashlib.sha256(" ".join((_CXX,) + _CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libvitsearch_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile into a temporary file of this process, then move it onto
    ``path`` in one step."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_CXX, *_CXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{_CXX} failed (rc {proc.returncode}): {proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_longlong)
        lib.vs_estimate_mac.restype = ctypes.c_longlong
        lib.vs_estimate_mac.argtypes = [i64p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
        common = [i64p, ctypes.c_int, i64p, i64p, i64p]
        tail = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_ulonglong, i64p, ctypes.c_int]
        lib.vs_gen_random.restype = ctypes.c_int
        lib.vs_gen_random.argtypes = common + [ctypes.c_double] + tail
        lib.vs_mutate.restype = ctypes.c_int
        lib.vs_mutate.argtypes = common + [ctypes.c_double, ctypes.c_double] + tail
        lib.vs_crossover.restype = ctypes.c_int
        lib.vs_crossover.argtypes = [i64p] + common + [ctypes.c_double] + tail
        _lib = lib
    except Exception as e:  # no compiler, or the build failed
        _load_error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library is unavailable (``None`` if it loaded or was not tried)."""
    return _load_error


# --- encoding ----------------------------------------------------------------


def encode_net(network_def: Sequence) -> np.ndarray:
    out = np.zeros((len(network_def), _FIELDS), dtype=np.int64)
    for i, block in enumerate(network_def):
        btype = nd.block_type(block)
        out[i, 0] = btype
        if btype in (nd.LINEAR_EMBED, nd.CONV_EMBED):
            out[i, 1] = block[1]
        elif btype == nd.FLEX_CONV_EMBED:
            out[i, 1], out[i, 2] = block[1], block[2]
        elif btype == nd.TRANSFORMER:
            (e, h, d), (_, ffn) = block[1], block[2]
            out[i, 1:6] = (e, h, d, ffn, int(block[3]))
        elif btype in (nd.HEAD, nd.SPATIAL_REDUCTION):
            out[i, 1], out[i, 2] = block[1], block[2]
    return out.reshape(-1)


def decode_net(flat: np.ndarray, template: Sequence) -> nd.NetworkDef:
    flat = flat.reshape(len(template), _FIELDS)
    blocks = []
    for i in range(len(template)):
        btype = int(flat[i, 0])
        f = [int(x) for x in flat[i]]
        if btype in (nd.LINEAR_EMBED, nd.CONV_EMBED):
            blocks.append((btype, f[1]))
        elif btype == nd.FLEX_CONV_EMBED:
            blocks.append((btype, f[1], f[2]))
        elif btype == nd.TRANSFORMER:
            blocks.append((1, (f[1], f[2], f[3]), (f[1], f[4]), f[5]))
        else:
            blocks.append((btype, f[1], f[2]))
    return tuple(blocks)


def encode_space(space: Sequence) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    vals: List[int] = []
    offs = np.zeros(len(space) * 3, dtype=np.int64)
    lens = np.zeros(len(space) * 3, dtype=np.int64)

    def push(block: int, j: int, widths) -> None:
        offs[block * 3 + j] = len(vals)
        lens[block * 3 + j] = len(widths)
        vals.extend(int(w) for w in widths)

    for i, keep in enumerate(space):
        if keep is None:
            continue
        if isinstance(keep, dict):
            push(i, 0, keep["attn"])
            push(i, 1, keep["mlp"])
            if keep.get("layer") is not None:
                push(i, 2, keep["layer"])
        else:
            push(i, 0, keep)
    return np.asarray(vals, dtype=np.int64), offs, lens


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


class NativeSearchOps:
    """Cost model + generators backed by the C++ library."""

    def __init__(self, largest_def: Sequence, space: Sequence, constraint: float,
                 distill: bool, input_resolution: int = 224, patch_size: int = 14):
        if not available():
            raise RuntimeError(f"native library unavailable: {_load_error}")
        self.lib = _load()
        self.template = nd.to_immutable(largest_def)
        self.largest = encode_net(largest_def)
        self.vals, self.offs, self.lens = encode_space(space)
        self.n = len(largest_def)
        self.constraint = float(constraint)
        self.distill = int(distill)
        self.resolution = int(input_resolution)
        self.patch = int(patch_size)

    def estimate_mac(self, network_def: Sequence) -> int:
        flat = encode_net(network_def)
        return int(self.lib.vs_estimate_mac(_ptr(flat), self.n, self.distill,
                                            self.resolution, self.patch, 3, 1))

    def _tail_args(self, seed: int, out: np.ndarray):
        return (self.distill, self.resolution, self.patch,
                ctypes.c_ulonglong(seed), _ptr(out), _MAX_TRIES)

    def gen_random(self, seed: int) -> nd.NetworkDef:
        out = np.zeros(self.n * _FIELDS, dtype=np.int64)
        rc = self.lib.vs_gen_random(_ptr(self.largest), self.n, _ptr(self.vals),
                                    _ptr(self.offs), _ptr(self.lens),
                                    self.constraint, *self._tail_args(seed, out))
        if rc < 0:
            raise RuntimeError("native gen_random failed to satisfy constraint")
        return decode_net(out, self.template)

    def mutate(self, parent: Sequence, m_prob: float, seed: int) -> nd.NetworkDef:
        flat = encode_net(parent)
        out = np.zeros(self.n * _FIELDS, dtype=np.int64)
        rc = self.lib.vs_mutate(_ptr(flat), self.n, _ptr(self.vals),
                                _ptr(self.offs), _ptr(self.lens),
                                float(m_prob), self.constraint,
                                *self._tail_args(seed, out))
        if rc < 0:
            raise RuntimeError("native mutate failed to satisfy constraint")
        return decode_net(out, self.template)

    def crossover(self, mother: Sequence, father: Sequence, seed: int) -> nd.NetworkDef:
        mf, ff = encode_net(mother), encode_net(father)
        out = np.zeros(self.n * _FIELDS, dtype=np.int64)
        rc = self.lib.vs_crossover(_ptr(mf), _ptr(ff), self.n, _ptr(self.vals),
                                   _ptr(self.offs), _ptr(self.lens),
                                   self.constraint, *self._tail_args(seed, out))
        if rc < 0:
            raise RuntimeError("native crossover failed to satisfy constraint")
        return decode_net(out, self.template)
