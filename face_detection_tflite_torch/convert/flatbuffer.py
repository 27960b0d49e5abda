"""Minimal read-only FlatBuffer access layer.

A FlatBuffer file is a graph of tables, vectors, strings and structs linked by
relative offsets.  This module implements just enough of the wire format to
read TFLite model files (see ``tflite.py``) without depending on the
``flatbuffers`` runtime or on generated schema code, so the converter stays a
pure ``numpy`` tool.

Wire format summary:

* All scalars are little-endian.
* A *table* is referenced by the absolute offset of its body.  The body starts
  with a signed 32-bit offset *back* to its vtable.  The vtable holds, per
  field slot, the 16-bit offset of that field within the table body (0 means
  "field absent, use default").  Field slot ``i`` lives at vtable byte
  ``4 + 2*i``.
* A *vector* is referenced by a 32-bit relative offset to a 32-bit length
  followed by the elements.
* A *string* is a vector of bytes (UTF-8), NUL-terminated (terminator not
  counted in the length).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

__all__ = ["Table"]

_U8 = struct.Struct("<B")
_I8 = struct.Struct("<b")
_U16 = struct.Struct("<H")
_I16 = struct.Struct("<h")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")

_SCALAR = {
    "uint8": _U8,
    "int8": _I8,
    "uint16": _U16,
    "int16": _I16,
    "uint32": _U32,
    "int32": _I32,
    "uint64": _U64,
    "int64": _I64,
    "float32": _F32,
    "float64": _F64,
    "bool": _U8,
}


class Table:
    """A view of one FlatBuffer table inside a shared byte buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    @classmethod
    def root(cls, buf: bytes) -> "Table":
        """Returns the root table of a FlatBuffer file."""
        (off,) = _U32.unpack_from(buf, 0)
        return cls(buf, off)

    # -- low-level -----------------------------------------------------------

    def _field_pos(self, slot: int) -> int:
        """Absolute position of field `slot`, or 0 if absent."""
        (vtable_rel,) = _I32.unpack_from(self.buf, self.pos)
        vtable = self.pos - vtable_rel
        (vsize,) = _U16.unpack_from(self.buf, vtable)
        field_off_pos = 4 + 2 * slot
        if field_off_pos >= vsize:
            return 0
        (field_off,) = _U16.unpack_from(self.buf, vtable + field_off_pos)
        if field_off == 0:
            return 0
        return self.pos + field_off

    def _indirect(self, pos: int) -> int:
        (rel,) = _U32.unpack_from(self.buf, pos)
        return pos + rel

    # -- typed accessors -----------------------------------------------------

    def scalar(self, slot: int, kind: str, default=0):
        """Reads an inline scalar field."""
        pos = self._field_pos(slot)
        if pos == 0:
            return default
        (value,) = _SCALAR[kind].unpack_from(self.buf, pos)
        if kind == "bool":
            return bool(value)
        return value

    def table(self, slot: int) -> Optional["Table"]:
        """Reads a sub-table field."""
        pos = self._field_pos(slot)
        if pos == 0:
            return None
        return Table(self.buf, self._indirect(pos))

    def string(self, slot: int) -> Optional[str]:
        pos = self._field_pos(slot)
        if pos == 0:
            return None
        vec = self._indirect(pos)
        (n,) = _U32.unpack_from(self.buf, vec)
        return self.buf[vec + 4 : vec + 4 + n].decode("utf-8")

    def _vector(self, slot: int):
        """Returns (element_start, length) for a vector field, or None."""
        pos = self._field_pos(slot)
        if pos == 0:
            return None
        vec = self._indirect(pos)
        (n,) = _U32.unpack_from(self.buf, vec)
        return vec + 4, n

    def vector_len(self, slot: int) -> int:
        v = self._vector(slot)
        return 0 if v is None else v[1]

    def scalar_vector(self, slot: int, dtype: str) -> np.ndarray:
        """Reads a vector of scalars as a numpy array (zero-copy view)."""
        v = self._vector(slot)
        if v is None:
            return np.empty(0, dtype=dtype)
        start, n = v
        itemsize = np.dtype(dtype).itemsize
        arr = np.frombuffer(self.buf, dtype=dtype, count=n, offset=start)
        assert arr.nbytes == n * itemsize
        return arr

    def table_vector(self, slot: int) -> list["Table"]:
        """Reads a vector of table offsets."""
        v = self._vector(slot)
        if v is None:
            return []
        start, n = v
        out = []
        for i in range(n):
            p = start + 4 * i
            out.append(Table(self.buf, self._indirect(p)))
        return out

    def union(self, type_slot: int, value_slot: int):
        """Reads a (type, table) union field pair."""
        utype = self.scalar(type_slot, "uint8", 0)
        table = self.table(value_slot)
        return utype, table
