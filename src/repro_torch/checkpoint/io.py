"""msgpack checkpoints of parameter / optimizer trees, in the reference's
file layout (repro/checkpoint/io.py), so a file either package writes is
read by the other.

Layout: one msgpack map {"metadata": {...}, "arrays": {flat_key: {"dtype",
"shape", "data"}}}, arrays in tree order (dict keys sorted). Flat keys are
the reference's '/'-joined JAX paths: a dict key, a list or tuple index,
or ".field" for a NamedTuple field (AdamState's ".step", ".mu/...").
Restores are structure-checked against a template tree.

The msgpack package is not a dependency of the port, so this module
encodes and decodes the subset of msgpack the layout uses (maps, str, bin,
arrays, ints, float64, nil and bool) itself, choosing each value's
smallest form as msgpack-python's `packb(use_bin_type=True)` does: for the
same tree and metadata the bytes are the reference's.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# dtype name (numpy's str(dtype), as the reference writes it) <-> torch.
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
# torch dtypes without a numpy counterpart travel as raw bits of this width.
_BITS = {torch.bfloat16: torch.int16}


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_head(len(b), 0xa0, 32, b"\xd9", b"\xda", b"\xdb") + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_head(len(b), None, 0, b"\xc4", b"\xc5", b"\xc6") + b)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, None, b"\xdc", b"\xdd"))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, None, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def _head(n: int, fix: Optional[int], fix_limit: int, b8, b16, b32) -> bytes:
    """The header of a str, bin, array or map of length n: the fixed form
    below fix_limit, then the 8-, 16- and 32-bit length forms."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    if b8 is not None and n < 1 << 8:
        return b8 + struct.pack(">B", n)
    if n < 1 << 16:
        return b16 + struct.pack(">H", n)
    if n < 1 << 32:
        return b32 + struct.pack(">I", n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((b"\xcc", ">B", 1 << 8),
                                 (b"\xcd", ">H", 1 << 16),
                                 (b"\xce", ">I", 1 << 32),
                                 (b"\xcf", ">Q", 1 << 64)):
            if n < limit:
                return code + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((b"\xd0", ">b", 1 << 7),
                                 (b"\xd1", ">h", 1 << 15),
                                 (b"\xd2", ">i", 1 << 31),
                                 (b"\xd3", ">q", 1 << 63)):
            if n >= -limit:
                return code + struct.pack(fmt, n)
    raise ValueError(f"int {n} out of msgpack's range")


# type byte -> (struct format, size) of the fixed-width scalars.
_SCALARS = {0xcb: (">d", 8), 0xcc: (">B", 1),
            0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4),
            0xd3: (">q", 8)}
# type byte -> (kind, width of the length field) of the sized values.
_SIZED = {0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4)}


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    """(the value at buf[i], the offset past it)."""
    t = buf[i]
    i += 1
    if t < 0x80:
        return t, i
    if t >= 0xe0:
        return t - 0x100, i
    if t == 0xc0:
        return None, i
    if t in (0xc2, 0xc3):
        return t == 0xc3, i
    if t in _SCALARS:
        fmt, size = _SCALARS[t]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if 0x80 <= t <= 0x8f:
        kind, n = "map", t & 0x0f
    elif 0x90 <= t <= 0x9f:
        kind, n = "array", t & 0x0f
    elif 0xa0 <= t <= 0xbf:
        kind, n = "str", t & 0x1f
    elif t in _SIZED:
        kind, width = _SIZED[t]
        n = int.from_bytes(buf[i:i + width], "big")
        i += width
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
    if kind == "str":
        return buf[i:i + n].decode("utf-8"), i + n
    if kind == "bin":
        return bytes(buf[i:i + n]), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, i = _unpack(buf, i)
            out.append(x)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(buf: bytes) -> Any:
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack "
                         f"object")
    return obj


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _items(tree: Any, prefix: Tuple[str, ...] = ()):
    """(flat key, leaf) in JAX's flattening order: dict keys sorted,
    sequences in order, None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", None)
        for j, x in enumerate(tree):
            yield from _items(x, prefix + ((f".{fields[j]}",) if fields
                                           else (str(j),)))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree: Any, flat: Dict[str, torch.Tensor],
             prefix: Tuple[str, ...] = ()) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", None)
        items = [_rebuild(x, flat, prefix + ((f".{fields[j]}",) if fields
                                             else (str(j),)))
                 for j, x in enumerate(tree)]
        return type(tree)(*items) if fields else type(tree)(items)
    return flat["/".join(prefix)]


def _record(leaf: Any) -> Dict:
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
    bits = t.view(_BITS[t.dtype]) if t.dtype in _BITS else t
    return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
            "data": bits.numpy().tobytes()}


def _tensor(rec: Dict) -> torch.Tensor:
    dtype = _DTYPES[rec["dtype"]]
    if not rec["data"]:
        return torch.empty(rec["shape"], dtype=dtype)
    raw = np.frombuffer(rec["data"], dtype=np.uint8).copy()
    t = torch.from_numpy(raw).view(_BITS.get(dtype, dtype))
    return t.view(dtype).reshape(rec["shape"])


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[Dict] = None) -> None:
    """Write `tree` (tensors or numpy arrays; dicts, lists, tuples and
    NamedTuples) and a msgpack-able metadata dict to `path`, atomically
    (a temporary file, then os.replace)."""
    payload = {"metadata": metadata or {},
               "arrays": {k: _record(v) for k, v in _items(tree)}}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)


def load_checkpoint(path: str, template: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of `template`: (tree, metadata). Each
    leaf keeps the dtype it was saved with and goes to the device of the
    template's leaf (the CPU for a numpy leaf). A key the template has and
    the file lacks, a key the file has and the template lacks, or a shape
    that differs from the template's raises ValueError."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    arrays = payload["arrays"]
    tmpl = dict(_items(template))
    missing = set(tmpl) - set(arrays)
    extra = set(arrays) - set(tmpl)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={missing} "
                         f"extra={extra}")
    flat = {}
    for k, t in tmpl.items():
        x = _tensor(arrays[k])
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(x.shape)} != template "
                             f"{tuple(t.shape)}")
        flat[k] = x.to(t.device) if isinstance(t, torch.Tensor) else x
    return _rebuild(template, flat), payload["metadata"]
