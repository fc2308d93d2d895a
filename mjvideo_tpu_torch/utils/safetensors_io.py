"""The safetensors format, read and written with PyTorch alone.

A file is an 8-byte little-endian header length N, then N bytes of JSON
mapping each tensor's name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the data that follows; an optional ``__metadata__``
maps strings to strings), then the raw little-endian bytes.  The port
reads and writes the format itself, so that serving needs no
``safetensors`` package, on one code path everywhere: a tensor is read with
``torch.frombuffer`` over a copy-on-write mmap of the file (no copy until it
moves; BF16, the published InternVL2 checkpoints' dtype, which numpy
cannot hold, reads as ``torch.bfloat16``), and written from its contiguous
bytes.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
}
NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str):
    """(the header's tensor entries, its ``__metadata__`` or None, the byte
    offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over a
    copy-on-write mmap of it (each keeps the mapping alive)."""
    header, _, start = read_header(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size else bytearray())
    out = {}
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {e['dtype']!r}, "
                             f"not one of {sorted(DTYPES)}")
        dtype = DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        numel = math.prod(shape)
        if numel * dtype.itemsize != end - begin:
            raise ValueError(f"{path}: {name}'s {end - begin} bytes do not "
                             f"hold {e['dtype']} {list(shape)}")
        out[name] = (torch.frombuffer(buf, dtype=dtype, count=numel,
                                      offset=start + begin).reshape(shape)
                     if numel else torch.empty(shape, dtype=dtype))
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> None:
    """Write ``tensors`` (on any device, of any layout) to ``path``, each
    cast to ``dtype`` where given.  Each tensor is made contiguous and
    brought to the host one at a time as it is written, so its bytes are
    its values in row-major order whatever its strides (a transposed view
    is not written in its storage's order) and no second copy of the
    whole state is held.  Tensors are laid out by element size, largest
    first, and the header is padded to 8 bytes, so that every tensor
    starts aligned."""
    def out_dtype(t):
        return dtype or t.dtype

    for name, t in tensors.items():
        if out_dtype(t) not in NAMES:
            raise ValueError(f"{name}: dtype {out_dtype(t)} has no "
                             "safetensors name")
    order = sorted(tensors, key=lambda k: (-out_dtype(tensors[k]).itemsize, k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * out_dtype(t).itemsize
        header[name] = {"dtype": NAMES[out_dtype(t)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            t = t.to(device="cpu", dtype=out_dtype(t)).contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
