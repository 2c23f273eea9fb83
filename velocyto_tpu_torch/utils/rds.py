# Copy of velocyto_tpu/utils/rds.py; imports nothing of the JAX package.
"""Minimal R RDS deserializer (R-free replacement for the rpy2 bridge).

The reference reads dropEst's `.rds` output through rpy2/R
(reference: velocyto/r_interface.py:10-54, commands/dropest_bc_correct.py).
This module implements just enough of R's serialization format (XDR
binary, version 2/3, optionally gzip/bzip2/xz compressed) to extract the
`merge_targets` named character vector -- and in practice decodes any
list/vector tree of the common SEXP types into python objects.

Format reference: R internals "serialization formats" (public spec).
"""
from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from typing import Any, Dict, List, Optional, Tuple

# SEXP type codes
NILSXP, SYMSXP, LISTSXP, CLOSXP, ENVSXP, PROMSXP, LANGSXP = 0, 1, 2, 3, 4, 5, 6
SPECIALSXP, BUILTINSXP, CHARSXP, LGLSXP = 7, 8, 9, 10
INTSXP, REALSXP, CPLXSXP, STRSXP, DOTSXP, ANYSXP, VECSXP = \
    13, 14, 15, 16, 17, 18, 19
EXPRSXP, BCODESXP, EXTPTRSXP, WEAKREFSXP, RAWSXP, S4SXP = 20, 21, 22, 23, 24, 25
ALTREP_SXP = 238
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 242
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 246
NAMESPACESXP = 249
PACKAGESXP = 248
REFSXP = 255
EMPTYENV_SXP = 242


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.refs: List[Any] = []

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise EOFError("truncated RDS stream")
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.read(8))[0]


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:3] == b"BZh":
        return bz2.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    return raw


def read_rds(path: str) -> Any:
    """Read an .rds file into python objects (dicts for named lists/vectors,
    lists otherwise, numpy-free scalars)."""
    with open(path, "rb") as f:
        raw = f.read()
    data = _decompress(raw)
    r = _Reader(data)
    magic = r.read(2)
    if magic == b"X\n":
        pass
    elif magic == b"A\n":
        raise NotImplementedError("ASCII RDS serialization not supported")
    elif magic == b"B\n":
        raise NotImplementedError("native-binary RDS not supported")
    else:
        raise ValueError("not an RDS file (bad magic)")
    version = r.u32()
    _writer = r.u32()
    _min_reader = r.u32()
    if version >= 3:
        nenc = r.u32()
        r.read(nenc)  # native encoding name
    return _unwrap(_read_item(r))


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, _RObj):
        return obj.to_python()
    return obj


class _RObj:
    """An R object with attributes."""

    def __init__(self, value: Any, attrib: Optional[Dict[str, Any]] = None
                 ) -> None:
        self.value = value
        self.attrib = attrib or {}

    def to_python(self) -> Any:
        v = self.value
        names = self.attrib.get("names")
        if isinstance(v, list) and names is not None:
            names_list = names.value if isinstance(names, _RObj) else names
            if isinstance(names_list, list) and len(names_list) == len(v):
                return {str(n): _unwrap(x) for n, x in zip(names_list, v)}
        if isinstance(v, list):
            return [_unwrap(x) for x in v]
        return v


def _read_flags(r: _Reader) -> Tuple[int, bool, bool, bool]:
    flags = r.u32()
    ptype = flags & 0xFF
    has_attr = bool(flags & (1 << 9))
    has_tag = bool(flags & (1 << 10))
    is_object = bool(flags & (1 << 8))
    return ptype, has_attr, has_tag, is_object


def _read_item(r: _Reader) -> Any:
    ptype, has_attr, has_tag, _obj = _read_flags(r)

    if ptype == NILVALUE_SXP or ptype == NILSXP:
        return None
    if ptype == REFSXP:
        # reference index is packed in the upper bits or follows as int
        idx = (r.data[r.pos - 4:r.pos] and 0) or 0
        # re-read the flags word we consumed to extract the packed index
        flags = struct.unpack(">I", r.data[r.pos - 4:r.pos])[0]
        idx = flags >> 8
        if idx == 0:
            idx = r.u32()
        return r.refs[idx - 1]
    if ptype == SYMSXP:
        sym = _read_item(r)
        name = sym.value if isinstance(sym, _RObj) else sym
        r.refs.append(name)
        return name
    if ptype == CHARSXP:
        n = r.i32()
        if n == -1:
            return None
        return r.read(n).decode("utf-8", errors="replace")
    if ptype in (LISTSXP, LANGSXP):
        # pairlist: attrib? tag? car cdr
        attrib = _read_item(r) if has_attr else None
        tag = _read_item(r) if has_tag else None
        car = _read_item(r)
        cdr = _read_item(r)
        pairs = [(tag, car)]
        while isinstance(cdr, _PairList):
            pairs.extend(cdr.pairs)
            cdr = None
        if isinstance(cdr, tuple):
            pairs.extend(cdr)
        pl = _PairList(pairs)
        _ = attrib
        return pl
    if ptype == LGLSXP:
        n = r.i32()
        vals = [None if (x := r.i32()) == -2147483648 else bool(x)
                for _ in range(n)]
        return _with_attr(r, _RObj(vals), has_attr)
    if ptype == INTSXP:
        n = r.i32()
        vals = [r.i32() for _ in range(n)]
        vals = [None if v == -2147483648 else v for v in vals]
        return _with_attr(r, _RObj(vals if n != 1 else vals), has_attr)
    if ptype == REALSXP:
        n = r.i32()
        vals = [r.f64() for _ in range(n)]
        return _with_attr(r, _RObj(vals), has_attr)
    if ptype == STRSXP:
        n = r.i32()
        vals = [_read_item(r) for _ in range(n)]
        return _with_attr(r, _RObj(vals), has_attr)
    if ptype == VECSXP or ptype == EXPRSXP:
        n = r.i32()
        vals = [_read_item(r) for _ in range(n)]
        return _with_attr(r, _RObj(vals), has_attr)
    if ptype == RAWSXP:
        n = r.i32()
        return _with_attr(r, _RObj(r.read(n)), has_attr)
    if ptype == ALTREP_SXP:
        info = _read_item(r)
        state = _read_item(r)
        _attr = _read_item(r)
        return _decode_altrep(info, state)
    raise NotImplementedError(f"RDS SEXP type {ptype} not supported")


class _PairList:
    def __init__(self, pairs) -> None:
        self.pairs = pairs

    def to_dict(self) -> Dict[str, Any]:
        return {str(t): _unwrap(v) for t, v in self.pairs if t is not None}


def _with_attr(r: _Reader, obj: "_RObj", has_attr: bool) -> "_RObj":
    if has_attr:
        attrib = _read_item(r)
        if isinstance(attrib, _PairList):
            obj.attrib = attrib.to_dict()
    # scalar unwrap for length-1 unnamed vectors happens in to_python
    return obj


def _decode_altrep(info: Any, state: Any) -> Any:
    """Decode common ALTREP payloads (compact_intseq, wrappers)."""
    name = None
    if isinstance(info, _PairList) and info.pairs:
        name = info.pairs[0][1]
    if name == "compact_intseq":
        vals = _unwrap(state)
        if isinstance(vals, list) and len(vals) == 3:
            n, start, step = vals
            return _RObj([int(start + i * step) for i in range(int(n))])
    if name in ("wrap_integer", "wrap_real", "wrap_string", "wrap_logical"):
        if isinstance(state, _PairList) and state.pairs:
            return state.pairs[0][1]
        if isinstance(state, _RObj) and isinstance(state.value, list) and \
                state.value:
            return state.value[0]
    # fallback: first payload of the state
    if isinstance(state, _RObj):
        return state
    return _RObj([])
