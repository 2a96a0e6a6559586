"""A reader of the safetensors format, written against the format itself
(counterpart of the ``safetensors.safe_open`` calls of
``gllm_tpu/models/loader.py:103,137``); it never imports the
``safetensors`` package, which the card's machine does not have.

A file is an 8-byte little-endian header length N, N bytes of a JSON
header, then the data. The header maps each tensor's name to its
``dtype``, ``shape`` and ``data_offsets`` ([begin, end), relative to the
first byte after the header); an optional ``__metadata__`` entry holds
strings. A tensor's bytes are little-endian and C-ordered.

:meth:`SafetensorsFile.get_tensor` reads a tensor's byte range with one
positional read into a buffer (a fresh one, or the caller's, such as the
loader's pinned staging buffer) and views it with ``torch.frombuffer``:
a bfloat16 tensor comes straight from its bytes (numpy has no bfloat16).
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

# the format's dtype names this reader takes. F8_E4M3 / F8_E5M2 (block-
# quantized checkpoints) raise: the loader's rules have none for their
# weight_scale_inv companions
DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}


class TensorInfo(NamedTuple):
    dtype: str                  # the format's name, e.g. "BF16"
    shape: Tuple[int, ...]
    offset: int                 # absolute byte offset in the file
    nbytes: int


class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed at open, tensors read
    on demand. Use as a context manager, or call :meth:`close`."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            head = os.pread(self._fd, 8, 0)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no "
                                 "header length)")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(self._fd).st_size
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} past the end "
                                 f"of the file ({size} bytes)")
            header = json.loads(os.pread(self._fd, n, 8))
        except BaseException:
            self.close()
            raise
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        base = 8 + n
        self.tensors: Dict[str, TensorInfo] = {}
        for name, h in header.items():
            begin, end = h["data_offsets"]
            if not 0 <= begin <= end or base + end > size:
                raise ValueError(f"{path}: tensor {name!r} has data offsets "
                                 f"{h['data_offsets']} outside the file")
            self.tensors[name] = TensorInfo(h["dtype"], tuple(h["shape"]),
                                            base + begin, end - begin)

    def keys(self) -> Iterator[str]:
        return iter(self.tensors)

    def torch_dtype(self, name: str) -> torch.dtype:
        """The tensor's torch dtype; raises on a dtype this reader does not
        take, naming it."""
        code = self.tensors[name].dtype
        if code not in DTYPES:
            raise NotImplementedError(
                f"{self.path}: tensor {name!r} has dtype {code}; the reader "
                f"takes {', '.join(DTYPES)}")
        return DTYPES[code]

    def get_tensor(self, name: str,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tensor ``name`` on the CPU, in its file dtype. With ``out``
        (a contiguous uint8 CPU tensor of at least its byte size) the bytes
        land there and the result is a view of it, valid until ``out`` is
        written again; else in a buffer of its own."""
        info = self.tensors[name]
        dtype = self.torch_dtype(name)
        numel = math.prod(info.shape)
        itemsize = torch.empty(0, dtype=dtype).element_size()
        if numel * itemsize != info.nbytes:
            raise ValueError(
                f"{self.path}: tensor {name!r} of shape {info.shape} and "
                f"dtype {info.dtype} spans {info.nbytes} bytes, not "
                f"{numel * itemsize}")
        if numel == 0:
            return torch.empty(info.shape, dtype=dtype)
        if out is None:
            buf = torch.empty(info.nbytes, dtype=torch.uint8)
        else:
            if (out.dtype != torch.uint8 or out.device.type != "cpu"
                    or not out.is_contiguous() or out.numel() < info.nbytes):
                raise ValueError("out must be a contiguous uint8 CPU tensor "
                                 f"of at least {info.nbytes} bytes")
            buf = out[:info.nbytes]
        view = memoryview(buf.numpy()).cast("B")
        done = 0
        while done < info.nbytes:
            got = os.preadv(self._fd, [view[done:]], info.offset + done)
            if got <= 0:
                raise ValueError(f"{self.path}: short read of tensor "
                                 f"{name!r} ({done} of {info.nbytes} bytes)")
            done += got
        return torch.frombuffer(view, dtype=dtype).view(info.shape)

    def close(self) -> None:
        if getattr(self, "_fd", -1) >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
