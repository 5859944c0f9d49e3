"""A stdlib MessagePack encoder and decoder for the checkpoint header.

The JAX package writes its checkpoint header with ``msgpack.packb``; the
port must read and write the same bytes where ``msgpack`` is not
installed. The header holds only maps with string keys, strings,
non-negative integers and lists, so only those are supported, each in the
smallest encoding, as ``msgpack.packb`` chooses it:

* int: positive fixint (< 2**7), then uint8, uint16, uint32, uint64;
* str (UTF-8): fixstr (< 32 bytes), then str8, str16, str32;
* list: fixarray (< 16 entries), then array16, array32;
* dict: fixmap (< 16 entries), then map16, map32.

:func:`packb` raises ``TypeError`` on any other value (negative ints,
bools, floats, bytes, None, ...); :func:`unpackb` raises ``ValueError`` on
any other format byte or on truncated or trailing data.
"""
from __future__ import annotations

import struct

_UINT = ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"),
         (1 << 64, 0xCF, ">Q"))


def _header(out: bytearray, n: int, fix_base: int, fix_limit: int,
            wide: tuple) -> None:
    """Append a length header: the fix form below ``fix_limit``, else the
    first of ``wide`` ((limit, code, struct format), ...) that holds n."""
    if n < fix_limit:
        out.append(fix_base | n)
        return
    for limit, code, fmt in wide:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise TypeError(f"length {n} does not fit a MessagePack header")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or not isinstance(obj, (int, str, list, dict)):
        raise TypeError(f"cannot pack {type(obj).__name__} "
                        f"(only maps, strings, non-negative ints and lists)")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError(f"cannot pack negative int {obj}")
        if obj < 0x80:
            out.append(obj)
            return
        for limit, code, fmt in _UINT:
            if obj < limit:
                out.append(code)
                out += struct.pack(fmt, obj)
                return
        raise TypeError(f"int {obj} does not fit in 64 bits")
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, ((1 << 8, 0xD9, ">B"),
                                           (1 << 16, 0xDA, ">H"),
                                           (1 << 32, 0xDB, ">I")))
        out += data
        return
    if isinstance(obj, list):
        _header(out, len(obj), 0x90, 16, ((1 << 16, 0xDC, ">H"),
                                          (1 << 32, 0xDD, ">I")))
        for item in obj:
            _pack(item, out)
        return
    _header(out, len(obj), 0x80, 16, ((1 << 16, 0xDE, ">H"),
                                      (1 << 32, 0xDF, ">I")))
    for key, value in obj.items():
        _pack(key, out)
        _pack(value, out)


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the supported types."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# Format byte -> (kind, struct format of its length or value).
_WIDE = {0xCC: ("int", ">B"), 0xCD: ("int", ">H"), 0xCE: ("int", ">I"),
         0xCF: ("int", ">Q"), 0xD9: ("str", ">B"), 0xDA: ("str", ">H"),
         0xDB: ("str", ">I"), 0xDC: ("list", ">H"), 0xDD: ("list", ">I"),
         0xDE: ("dict", ">H"), 0xDF: ("dict", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos: self.pos + n]
        self.pos += n
        return chunk

    def value(self):
        code = self.take(1)[0]
        if code < 0x80:
            return code
        if code < 0x90:
            kind, n = "dict", code & 0x0F
        elif code < 0xA0:
            kind, n = "list", code & 0x0F
        elif code < 0xC0:
            kind, n = "str", code & 0x1F
        elif code in _WIDE:
            kind, fmt = _WIDE[code]
            (n,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
            if kind == "int":
                return n
        else:
            raise ValueError(f"unsupported MessagePack format byte {code:#04x}")
        if kind == "str":
            return bytes(self.take(n)).decode("utf-8")
        if kind == "list":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the supported types."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of trailing data")
    return obj
