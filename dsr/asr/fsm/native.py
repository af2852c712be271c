"""ctypes binding to the native WFST core (native/wfst.cpp).

The C++ core implements the build-time hot ops — compose (3-state eps
filter), weighted determinization, rmepsilon, connect — with semantics
mirroring the pure-Python `Wfst` methods (the tested oracle).  `Wfst`
dispatches here automatically when the shared library is present; set
`DSR_NO_NATIVE=1` (or `set_enabled(False)`) to force the Python path
(tests exercise both).

Graphs cross the boundary as CSR arrays: int64 per-state arc offsets,
int32 ilabel/olabel/nextstate, f32 weights, and a dense f32 final-weight
vector (+inf = non-final).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from dsr.asr.fsm.wfst import INF, Wfst
from dsr.utils import nativelib

_lib = None
_enabled = os.environ.get("DSR_NO_NATIVE", "0") != "1"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(nativelib.ensure_built()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dsr_fst_create.restype = ctypes.c_void_p
    lib.dsr_fst_create.argtypes = [
        ctypes.c_int, ctypes.c_int64, i64p, i32p, i32p, f32p, i32p,
        ctypes.c_int, f32p,
    ]
    lib.dsr_fst_free.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_num_states.restype = ctypes.c_int
    lib.dsr_fst_num_states.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_num_arcs.restype = ctypes.c_int64
    lib.dsr_fst_num_arcs.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_start.restype = ctypes.c_int
    lib.dsr_fst_start.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_copy_out.argtypes = [
        ctypes.c_void_p, i64p, i32p, i32p, f32p, i32p, f32p,
    ]
    lib.dsr_fst_compose.restype = ctypes.c_void_p
    lib.dsr_fst_compose.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dsr_fst_determinize.restype = ctypes.c_void_p
    lib.dsr_fst_determinize.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dsr_fst_rmepsilon.restype = ctypes.c_void_p
    lib.dsr_fst_rmepsilon.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_connect.restype = ctypes.c_void_p
    lib.dsr_fst_connect.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_arcsort.restype = None
    lib.dsr_fst_arcsort.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_max_outdeg.restype = ctypes.c_int64
    lib.dsr_fst_max_outdeg.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _enabled and _load() is not None


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = flag


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _to_handle(lib, f: Wfst, sort_ilabel: bool = False):
    n = f.num_states
    na = f.num_arcs
    off = np.zeros(n + 1, np.int64)
    il = np.empty(na, np.int32)
    ol = np.empty(na, np.int32)
    w = np.empty(na, np.float32)
    nxt = np.empty(na, np.int32)
    fin = np.full(n, np.inf, np.float32)
    p = 0
    for s in range(n):
        arcs = f.arcs[s]
        if sort_ilabel:
            arcs = sorted(arcs, key=lambda a: a.ilabel)
        for a in arcs:
            il[p], ol[p], w[p], nxt[p] = a.ilabel, a.olabel, a.weight, a.nextstate
            p += 1
        off[s + 1] = p
    for s, fw in f.finals.items():
        fin[s] = fw
    h = lib.dsr_fst_create(
        n, na, _ptr(off, ctypes.c_int64), _ptr(il, ctypes.c_int32),
        _ptr(ol, ctypes.c_int32), _ptr(w, ctypes.c_float),
        _ptr(nxt, ctypes.c_int32), f.start, _ptr(fin, ctypes.c_float),
    )
    return h


def _from_handle(lib, h) -> Wfst:
    n = lib.dsr_fst_num_states(h)
    na = lib.dsr_fst_num_arcs(h)
    off = np.zeros(n + 1, np.int64)
    il = np.empty(na, np.int32)
    ol = np.empty(na, np.int32)
    w = np.empty(na, np.float32)
    nxt = np.empty(na, np.int32)
    fin = np.empty(max(n, 1), np.float32)
    if n:
        lib.dsr_fst_copy_out(
            h, _ptr(off, ctypes.c_int64), _ptr(il, ctypes.c_int32),
            _ptr(ol, ctypes.c_int32), _ptr(w, ctypes.c_float),
            _ptr(nxt, ctypes.c_int32), _ptr(fin, ctypes.c_float),
        )
    out = Wfst()
    for _ in range(n):
        out.add_state()
    if n:
        out.set_start(lib.dsr_fst_start(h))
    for s in range(n):
        for a in range(off[s], off[s + 1]):
            out.add_arc(s, int(il[a]), int(ol[a]), float(w[a]), int(nxt[a]))
        if np.isfinite(fin[s]):
            out.set_final(s, float(fin[s]))
    return out


def _unary(name):
    def op(f: Wfst, **kw) -> Wfst:
        lib = _load()
        h = _to_handle(lib, f)
        try:
            if name == "determinize":
                rh = lib.dsr_fst_determinize(h, kw.get("max_states", 1_000_000))
                if not rh:
                    raise RuntimeError(
                        "determinize exceeded max_states — input likely "
                        "violates the twins property (undeterminizable)"
                    )
            else:
                rh = getattr(lib, f"dsr_fst_{name}")(h)
        finally:
            lib.dsr_fst_free(h)
        try:
            return _from_handle(lib, rh)
        finally:
            lib.dsr_fst_free(rh)
    op.__name__ = name
    return op


determinize = _unary("determinize")
rmepsilon = _unary("rmepsilon")
connect = _unary("connect")


def compose(a: Wfst, b: Wfst) -> Wfst:
    lib = _load()
    ha = _to_handle(lib, a)
    hb = _to_handle(lib, b, sort_ilabel=True)  # C++ binary-searches B's arcs
    try:
        rh = lib.dsr_fst_compose(ha, hb)
    finally:
        lib.dsr_fst_free(ha)
        lib.dsr_fst_free(hb)
    try:
        return _from_handle(lib, rh)
    finally:
        lib.dsr_fst_free(rh)


class NativeFst:
    """Owning handle to a C++ Fst — ops chain handle→handle, so LVCSR-scale
    build pipelines (compose → determinize → compose → rmeps → connect)
    never round-trip through Python `Wfst` objects (O(arcs) Python loops).
    Only the final `to_csr()`/`to_wfst()` copies arrays out."""

    def __init__(self, handle, lib):
        if not handle:
            raise RuntimeError("native op returned null handle")
        self._h = handle
        self._lib = lib

    # ------------------------------------------------------------ lifecycle
    def __del__(self):
        self.free()

    def free(self):
        if getattr(self, "_h", None):
            self._lib.dsr_fst_free(self._h)
            self._h = None

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_wfst(cls, f: Wfst, sort_ilabel: bool = False) -> "NativeFst":
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        return cls(_to_handle(lib, f, sort_ilabel), lib)

    @classmethod
    def from_csr(cls, off, il, ol, w, nxt, start: int, fin) -> "NativeFst":
        """Create from CSR arrays directly (vectorised builders skip Python
        `Wfst` objects entirely).  off: (S+1,) int64; il/ol/nxt: (A,) int32;
        w: (A,) f32; fin: (S,) f32 (+inf = non-final)."""
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        off = np.ascontiguousarray(off, np.int64)
        il = np.ascontiguousarray(il, np.int32)
        ol = np.ascontiguousarray(ol, np.int32)
        w = np.ascontiguousarray(w, np.float32)
        nxt = np.ascontiguousarray(nxt, np.int32)
        fin = np.ascontiguousarray(fin, np.float32)
        S = len(off) - 1
        h = lib.dsr_fst_create(
            S, len(il), _ptr(off, ctypes.c_int64), _ptr(il, ctypes.c_int32),
            _ptr(ol, ctypes.c_int32), _ptr(w, ctypes.c_float),
            _ptr(nxt, ctypes.c_int32), start, _ptr(fin, ctypes.c_float),
        )
        return cls(h, lib)

    # ------------------------------------------------------------ properties
    @property
    def num_states(self) -> int:
        return self._lib.dsr_fst_num_states(self._h)

    @property
    def num_arcs(self) -> int:
        return self._lib.dsr_fst_num_arcs(self._h)

    @property
    def start(self) -> int:
        return self._lib.dsr_fst_start(self._h)

    @property
    def max_outdeg(self) -> int:
        return self._lib.dsr_fst_max_outdeg(self._h)

    # ------------------------------------------------------------------- ops
    def compose(self, other: "NativeFst") -> "NativeFst":
        """self ∘ other; sorts other's arcs in place first (C++ requires
        ilabel-sorted B for its binary search)."""
        self._lib.dsr_fst_arcsort(other._h)
        return NativeFst(self._lib.dsr_fst_compose(self._h, other._h), self._lib)

    def determinize(self, max_states: int = 10_000_000) -> "NativeFst":
        rh = self._lib.dsr_fst_determinize(self._h, max_states)
        if not rh:
            raise RuntimeError(
                "determinize exceeded max_states — input likely violates "
                "the twins property (undeterminizable)"
            )
        return NativeFst(rh, self._lib)

    def rmepsilon(self) -> "NativeFst":
        return NativeFst(self._lib.dsr_fst_rmepsilon(self._h), self._lib)

    def connect(self) -> "NativeFst":
        return NativeFst(self._lib.dsr_fst_connect(self._h), self._lib)

    # ---------------------------------------------------------------- export
    def to_csr(self):
        """→ (off int64 (S+1), il, ol int32, w f32, nxt int32, start, fin f32)."""
        lib, h = self._lib, self._h
        n = lib.dsr_fst_num_states(h)
        na = lib.dsr_fst_num_arcs(h)
        off = np.zeros(n + 1, np.int64)
        il = np.empty(na, np.int32)
        ol = np.empty(na, np.int32)
        w = np.empty(na, np.float32)
        nxt = np.empty(na, np.int32)
        fin = np.empty(max(n, 1), np.float32)
        if n:
            lib.dsr_fst_copy_out(
                h, _ptr(off, ctypes.c_int64), _ptr(il, ctypes.c_int32),
                _ptr(ol, ctypes.c_int32), _ptr(w, ctypes.c_float),
                _ptr(nxt, ctypes.c_int32), _ptr(fin, ctypes.c_float),
            )
        return off, il, ol, w, nxt, (lib.dsr_fst_start(h) if n else -1), fin[:n]

    def to_wfst(self) -> Wfst:
        return _from_handle(self._lib, self._h)
