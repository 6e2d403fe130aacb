"""A reader of the safetensors format, without the ``safetensors`` package.

A file is an 8-byte little-endian header length, a JSON header that maps
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end) into the byte buffer that follows, plus an optional
``__metadata__`` entry, then the buffer itself. ``load_file`` maps the
file into memory and views each tensor in place (``torch.frombuffer``):
nothing is copied or up-cast until the caller moves a tensor, so a bf16
shard costs its own bytes once, on its way to the card.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, Tuple

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
}


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the per-tensor header entries, the byte offset of the buffer)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, in its stored dtype, on
    ``device``. On the CPU the tensors are views of a private (copy on
    write) memory map of the file, which they keep alive."""
    header, base = read_header(path)
    for name, entry in header.items():
        if entry["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, which this "
                             f"reader does not map (it maps {', '.join(DTYPES)})")
    buf = b""
    if os.path.getsize(path) > base:
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, entry in header.items():
        dtype, shape = DTYPES[entry["dtype"]], entry["shape"]
        begin, end = entry["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        numel = math.prod(shape)
        if count != numel or (end - begin) % itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, not "
                             f"{numel} x {itemsize}")
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:  # a view needs an aligned start: copy the bytes
            t = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                                 offset=base + begin).clone().view(dtype).reshape(shape)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin).reshape(shape)
        out[name] = t.to(device)
    return out

