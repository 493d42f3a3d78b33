"""Minimal Apache Arrow IPC *file* reader and writer (no pyarrow).

A pod5 container embeds three Arrow IPC files (signal, reads, run info).
This module reads and writes exactly what the pod5 reader and writer use:

- reader: every fixed-width primitive (ints, floats, bool, temporal types
  as raw ints), binary/utf8 and their large variants, fixed-size binary,
  list/large-list, and dictionary-encoded columns (MinKNOW dictionary-
  encodes `end_reason`, `pore_type` and `run_info`). Other nested types
  (struct, map, fixed-size list, union, run-end) are walked over so the
  columns around them still decode. Compressed IPC bodies are refused.
- writer: one record batch of non-null columns of the types listed in
  `_TYPE_IDS` below.

Format: https://arrow.apache.org/docs/format/Columnar.html (IPC file
format, flatbuffer schema in format/Schema.fbs, Message.fbs, File.fbs).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"ARROW1"
_CONTINUATION = 0xFFFFFFFF
_V5 = 4  # MetadataVersion.V5

# Type union ids (Schema.fbs)
_NULL, _INT, _FLOAT, _BINARY, _UTF8, _BOOL, _DECIMAL, _DATE, _TIME = range(1, 10)
_TIMESTAMP, _INTERVAL, _LIST, _STRUCT, _UNION, _FIXED_BINARY = range(10, 16)
_FIXED_LIST, _MAP, _DURATION, _LARGE_BINARY, _LARGE_UTF8 = range(16, 21)
_LARGE_LIST, _RUN_END = 21, 22
_TYPE_IDS = {
    "int": _INT, "float": _FLOAT, "utf8": _UTF8, "large_binary": _LARGE_BINARY,
    "fixed_size_binary": _FIXED_BINARY, "list": _LIST,
}
# message header union ids (Message.fbs)
_H_SCHEMA, _H_DICT, _H_BATCH = 1, 2, 3


# ---------------------------------------------------------------------------
# flatbuffer reading
# ---------------------------------------------------------------------------


class _FB:
    """Read-only view of one flatbuffer table."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf, pos):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    @classmethod
    def root(cls, buf, start=0):
        return cls(buf, start + struct.unpack_from("<I", buf, start)[0])

    def _off(self, slot):
        o = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vt_len else 0

    def scalar(self, slot, fmt, default=0):
        o = self._off(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] if o else default

    def _deref(self, slot):
        o = self._off(slot)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, slot):
        p = self._deref(slot)
        return None if p is None else _FB(self.buf, p)

    def _vector(self, slot):
        p = self._deref(slot)
        if p is None:
            return 0, 0
        return p + 4, struct.unpack_from("<I", self.buf, p)[0]

    def string(self, slot):
        start, n = self._vector(slot)
        return bytes(self.buf[start : start + n]).decode()

    def tables(self, slot):
        start, n = self._vector(slot)
        out = []
        for i in range(n):
            p = start + 4 * i
            out.append(_FB(self.buf, p + struct.unpack_from("<I", self.buf, p)[0]))
        return out

    def structs(self, slot, fmt):
        start, n = self._vector(slot)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, start + i * size) for i in range(n)]


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Field:
    def __init__(self, fb: _FB):
        self.name = fb.string(0)
        self.type_id = fb.scalar(2, "B")
        self.type = fb.table(3)
        self.children = [_Field(c) for c in fb.tables(5)]
        enc = fb.table(4)
        self.dict_id = None if enc is None else enc.scalar(0, "q")
        self.index_type = None if enc is None else enc.table(1)

    def layout(self):
        """(field nodes, buffers) this field takes in a record batch."""
        if self.dict_id is not None:
            return 1, 2
        t = self.type_id
        own = {
            _NULL: 0, _BINARY: 3, _UTF8: 3, _LARGE_BINARY: 3, _LARGE_UTF8: 3,
            _LIST: 2, _LARGE_LIST: 2, _MAP: 2, _FIXED_LIST: 1, _STRUCT: 1,
            _RUN_END: 0,
        }.get(t)
        if own is None:
            if t == _UNION:
                own = 2 if self.type.scalar(0, "h") == 1 else 1  # dense: 2
            elif t in (_INT, _FLOAT, _BOOL, _DECIMAL, _DATE, _TIME,
                       _TIMESTAMP, _INTERVAL, _FIXED_BINARY, _DURATION):
                own = 2
            else:
                raise ValueError(f"column {self.name!r}: Arrow type id {t} is not supported")
        nodes, bufs = 1, own
        for c in self.children:
            cn, cb = c.layout()
            nodes, bufs = nodes + cn, bufs + cb
        return nodes, bufs


def _int_dtype(t: _FB) -> np.dtype:
    bits, signed = t.scalar(0, "i"), bool(t.scalar(1, "B"))
    return np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")


def _decode(field: _Field, nodes, bufs, body, dicts):
    """Decode one column of one record batch; consumes its nodes/buffers."""
    length, nulls = nodes.pop(0)
    _, nbuf = field.layout()
    own = [bufs.pop(0) for _ in range(nbuf - sum(c.layout()[1] for c in field.children))]

    def raw(i):
        off, size = own[i]
        return body[off : off + size]

    if nulls and field.type_id != _NULL:
        raise ValueError(f"column {field.name!r} has {nulls} nulls; not supported")
    if field.dict_id is not None:
        idx = np.frombuffer(raw(1), _int_dtype(field.index_type), count=length)
        values = dicts[field.dict_id]
        return [values[i] for i in idx]
    t = field.type_id
    if t == _INT:
        return np.frombuffer(raw(1), _int_dtype(field.type), count=length)
    if t == _FLOAT:
        dt = {0: "<f2", 1: "<f4", 2: "<f8"}[field.type.scalar(0, "h")]
        return np.frombuffer(raw(1), dt, count=length)
    if t == _BOOL:
        bits = np.frombuffer(raw(1), np.uint8)
        return np.unpackbits(bits, bitorder="little", count=length).astype(bool)
    if t in (_DATE, _TIME, _TIMESTAMP, _DURATION):  # raw ticks
        narrow = (t == _DATE and field.type.scalar(0, "h") == 0) or (
            t == _TIME and field.type.scalar(1, "i", 32) == 32
        )
        return np.frombuffer(raw(1), "<i4" if narrow else "<i8", count=length)
    if t == _FIXED_BINARY:
        w = field.type.scalar(0, "i")
        data = raw(1)
        return [bytes(data[i * w : (i + 1) * w]) for i in range(length)]
    if t in (_BINARY, _UTF8, _LARGE_BINARY, _LARGE_UTF8):
        odt = "<i8" if t in (_LARGE_BINARY, _LARGE_UTF8) else "<i4"
        offs = np.frombuffer(raw(1), odt, count=length + 1)
        data = raw(2)
        vals = [bytes(data[offs[i] : offs[i + 1]]) for i in range(length)]
        return [v.decode() for v in vals] if t in (_UTF8, _LARGE_UTF8) else vals
    if t in (_LIST, _LARGE_LIST):
        odt = "<i8" if t == _LARGE_LIST else "<i4"
        offs = np.frombuffer(raw(1), odt, count=length + 1)
        child = _decode(field.children[0], nodes, bufs, body, dicts)
        return [child[offs[i] : offs[i + 1]] for i in range(length)]
    # types the pod5 reader never asks for: skip their children and return
    # None so the columns after them still line up
    for c in field.children:
        cn, cb = c.layout()
        del nodes[:cn], bufs[:cb]
    return None


def _message(data, offset):
    """(Message table, body offset) of the encapsulated message at offset."""
    (first,) = struct.unpack_from("<I", data, offset)
    if first == _CONTINUATION:
        (meta_len,) = struct.unpack_from("<i", data, offset + 4)
        fb_start = offset + 8
    else:  # pre-1.0 framing without the continuation marker
        meta_len, fb_start = first, offset + 4
    return _FB.root(data, fb_start), fb_start + meta_len


class Table:
    """Columns of an Arrow IPC file, decoded on first access."""

    def __init__(self, fields, batches, dicts):
        self._fields = fields
        self._batches = batches  # [(rows, nodes, buffers, body)]
        self._dicts = dicts
        self._cache: dict = {}
        self.names = [f.name for f in fields]

    def __len__(self):
        return sum(b[0] for b in self._batches)

    def column(self, name: str):
        """numpy array for numeric columns, else a list of Python values."""
        if name not in self._cache:
            i = self.names.index(name)
            parts = []
            for _, nodes, bufs, body in self._batches:
                nodes, bufs = list(nodes), list(bufs)
                for f in self._fields[:i]:
                    n, b = f.layout()
                    del nodes[:n], bufs[:b]
                parts.append(_decode(self._fields[i], nodes, bufs, body, self._dicts))
            if parts and all(isinstance(p, np.ndarray) for p in parts):
                col = np.concatenate(parts)
            else:
                col = [v for p in parts for v in p]
            self._cache[name] = col
        return self._cache[name]


def _batch_parts(batch: _FB, data, body_off, body_len):
    if batch.table(3) is not None:
        raise ValueError(
            "compressed Arrow IPC bodies (LZ4/ZSTD buffer compression) are "
            "not supported"
        )
    nodes = batch.structs(1, "qq")
    bufs = batch.structs(2, "qq")
    body = memoryview(data)[body_off : body_off + body_len]
    return batch.scalar(0, "q"), nodes, bufs, body


def read_file(data: bytes | memoryview) -> Table:
    """Parse an Arrow IPC file held in memory."""
    data = memoryview(data)
    if bytes(data[:6]) != MAGIC or bytes(data[-6:]) != MAGIC:
        raise ValueError("not an Arrow IPC file")
    (footer_len,) = struct.unpack_from("<i", data, len(data) - 10)
    footer_start = len(data) - 10 - footer_len
    if not 8 <= footer_start < len(data):
        raise ValueError("bad Arrow IPC footer length")
    footer = _FB.root(data, footer_start)
    fields = [_Field(f) for f in footer.table(1).tables(1)]

    dict_fields = {}

    def collect(fs):
        for f in fs:
            if f.dict_id is not None:
                dict_fields[f.dict_id] = f
            collect(f.children)

    collect(fields)
    dicts: dict = {}
    for offset, _meta, body_len in footer.structs(2, "qi4xq"):
        msg, body_off = _message(data, offset)
        if msg.scalar(1, "B") != _H_DICT:
            raise ValueError("dictionary block is not a DictionaryBatch")
        d = msg.table(2)
        did, delta = d.scalar(0, "q"), bool(d.scalar(2, "B"))
        _, nodes, bufs, body = _batch_parts(d.table(1), data, body_off, body_len)
        vf = dict_fields[did]
        value_field = _Field.__new__(_Field)
        value_field.__dict__.update(vf.__dict__)
        value_field.dict_id = None
        values = list(_decode(value_field, list(nodes), list(bufs), body, dicts))
        dicts[did] = (dicts.get(did, []) + values) if delta else values
    batches = []
    for offset, _meta, body_len in footer.structs(3, "qi4xq"):
        msg, body_off = _message(data, offset)
        if msg.scalar(1, "B") != _H_BATCH:
            raise ValueError("record batch block is not a RecordBatch")
        batches.append(_batch_parts(msg.table(2), data, body_off, body_len))
    return Table(fields, batches, dicts)


# ---------------------------------------------------------------------------
# flatbuffer writing
# ---------------------------------------------------------------------------


class _T:
    """A flatbuffer table to serialize: slot -> (fmt, value) scalars,
    slot -> _T / _Vec / str children."""

    def __init__(self, **slots):
        self.slots = slots  # "s<i>": value


class _Vec:
    def __init__(self, items, struct_fmt=None):
        self.items, self.fmt = items, struct_fmt


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def _align(self, n, rem=0):
        while len(self.buf) % n != rem:
            self.buf.append(0)

    def _patch(self, at, target):
        struct.pack_into("<I", self.buf, at, target - at)

    def finish(self, root: _T) -> bytes:
        self.buf += b"\0" * 4
        self._patch(0, self._table(root))
        self._align(8)
        return bytes(self.buf)

    def _child(self, v):
        if isinstance(v, _T):
            return self._table(v)
        if isinstance(v, str):
            self._align(4)
            pos = len(self.buf)
            raw = v.encode()
            self.buf += struct.pack("<I", len(raw)) + raw + b"\0"
            return pos
        return self._vector(v)

    def _vector(self, v: _Vec):
        if v.fmt is not None:
            size = struct.calcsize("<" + v.fmt)
            self._align(8, 4) if size % 8 == 0 else self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(v.items))
            for it in v.items:
                self.buf += struct.pack("<" + v.fmt, *it)
            return pos
        self._align(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(v.items)) + b"\0" * (4 * len(v.items))
        for i, it in enumerate(v.items):
            self._patch(pos + 4 + 4 * i, self._child(it))
        return pos

    def _table(self, t: _T):
        slots = {int(k[1:]): v for k, v in t.slots.items() if v is not None}
        n = max(slots) + 1 if slots else 0
        scal = {s: v for s, v in slots.items() if isinstance(v, tuple)}
        refs = {s: v for s, v in slots.items() if not isinstance(v, tuple)}
        # inline layout: 8-byte scalars first (8-aligned), then 4, 2, 1
        order = sorted(scal, key=lambda s: -struct.calcsize("<" + scal[s][0]))
        order += sorted(refs)
        layout, off = {}, 4
        for s in order:
            size = struct.calcsize("<" + scal[s][0]) if s in scal else 4
            off = -(-off // size) * size
            layout[s] = (off, size)
            off += size
        tsize = -(-off // 4) * 4
        self._align(2)
        vt = len(self.buf)
        self.buf += struct.pack("<HH", 4 + 2 * n, tsize)
        self.buf += b"".join(
            struct.pack("<H", layout[s][0] if s in layout else 0) for s in range(n)
        )
        self._align(8)
        pos = len(self.buf)
        self.buf += b"\0" * tsize
        struct.pack_into("<i", self.buf, pos, pos - vt)
        for s, (fmt, val) in scal.items():
            struct.pack_into("<" + fmt, self.buf, pos + layout[s][0], val)
        for s in sorted(refs):
            self._patch(pos + layout[s][0], self._child(refs[s]))
        return pos


def _fb(root: _T) -> bytes:
    return _Writer().finish(root)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _type_table(spec) -> tuple[int, _T]:
    kind = spec[0]
    if kind == "int":
        return _INT, _T(s0=("i", spec[1]), s1=("B", int(spec[2])))
    if kind == "float":
        return _FLOAT, _T(s0=("h", {32: 1, 64: 2}[spec[1]]))
    if kind == "fixed_size_binary":
        return _FIXED_BINARY, _T(s0=("i", spec[1]))
    return _TYPE_IDS[kind], _T()


def _field_fb(name, spec) -> _T:
    tid, ttab = _type_table(spec)
    children = [_field_fb("item", spec[1])] if spec[0] == "list" else []
    return _T(s0=name, s1=("B", 1), s2=("B", tid), s3=ttab, s5=_Vec(children))


_NP = {
    ("int", 8, False): "<u1", ("int", 16, False): "<u2",
    ("int", 32, False): "<u4", ("int", 64, False): "<u8",
    ("int", 8, True): "<i1", ("int", 16, True): "<i2",
    ("int", 32, True): "<i4", ("int", 64, True): "<i8",
    ("float", 32): "<f4", ("float", 64): "<f8",
}


def _column_buffers(spec, values, nodes, bufs):
    """Append a column's field nodes and buffers (validity left empty)."""
    n = len(values)
    nodes.append((n, 0))
    bufs.append(b"")  # no validity bitmap: the column has no nulls
    kind = spec[0]
    if kind in ("int", "float"):
        bufs.append(np.asarray(values, _NP[tuple(spec)]).tobytes())
    elif kind == "fixed_size_binary":
        raw = b"".join(bytes(v) for v in values)
        if len(raw) != n * spec[1]:
            raise ValueError("fixed_size_binary values of the wrong width")
        bufs.append(raw)
    elif kind in ("utf8", "large_binary"):
        raw = [v.encode() if isinstance(v, str) else bytes(v) for v in values]
        offs = np.concatenate([[0], np.cumsum([len(r) for r in raw])])
        bufs.append(offs.astype("<i8" if kind == "large_binary" else "<i4").tobytes())
        bufs.append(b"".join(raw))
    elif kind == "list":
        offs = np.concatenate([[0], np.cumsum([len(v) for v in values])])
        bufs.append(offs.astype("<i4").tobytes())
        flat = np.concatenate([np.asarray(v) for v in values]) if n else []
        _column_buffers(spec[1], flat, nodes, bufs)
    else:
        raise ValueError(f"cannot write Arrow column type {spec!r}")


def _encapsulate(meta: bytes, body: bytes = b"") -> bytes:
    pad = (-(8 + len(meta))) % 8
    return (
        struct.pack("<Ii", _CONTINUATION, len(meta) + pad)
        + meta + b"\0" * pad + body
    )


def write_file(columns: list[tuple[str, tuple, object]]) -> bytes:
    """Serialize one record batch as an Arrow IPC file.

    columns: [(name, type spec, values)], all of one length, no nulls.
    Type specs: ("int", bits, signed), ("float", 32 | 64), ("utf8",),
    ("large_binary",), ("fixed_size_binary", width), ("list", child spec).
    """
    schema = _T(s0=("h", 0), s1=_Vec([_field_fb(n, s) for n, s, _ in columns]))
    nrows = len(columns[0][2]) if columns else 0
    nodes, raw_bufs = [], []
    for _, spec, vals in columns:
        if len(vals) != nrows:
            raise ValueError("columns differ in length")
        _column_buffers(spec, vals, nodes, raw_bufs)
    body, buf_meta = bytearray(), []
    for b in raw_bufs:
        buf_meta.append((len(body), len(b)))
        body += b + b"\0" * ((-len(b)) % 8)
    batch = _T(
        s0=("q", nrows),
        s1=_Vec(nodes, "qq"),
        s2=_Vec(buf_meta, "qq"),
    )
    schema_msg = _encapsulate(
        _fb(_T(s0=("h", _V5), s1=("B", _H_SCHEMA), s2=schema, s3=("q", 0)))
    )
    batch_meta = _encapsulate(
        _fb(_T(s0=("h", _V5), s1=("B", _H_BATCH), s2=batch, s3=("q", len(body))))
    )
    head = MAGIC + b"\0\0" + schema_msg
    out = head + batch_meta + bytes(body)
    out += struct.pack("<Ii", _CONTINUATION, 0)  # end-of-stream marker
    footer = _fb(
        _T(
            s0=("h", _V5),
            s1=schema,
            s2=_Vec([], "qi4xq"),
            s3=_Vec([(len(head), len(batch_meta), len(body))], "qi4xq"),
        )
    )
    return out + footer + struct.pack("<i", len(footer)) + MAGIC
