"""Checkpoint weights: a safetensors reader and writer, and ``.bin`` reading
(port of ``_load_safetensors``, ``legalrag_tpu/models/bert.py:185-204``).

The ``safetensors`` package is not imported: the format is parsed here. A
file is an 8-byte little-endian header length, a JSON header mapping each
tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (``[begin,
end)`` in the data section; an optional ``__metadata__`` entry of strings),
then the data section of raw little-endian bytes. numpy has no bfloat16, so
every tensor is read by ``torch.frombuffer``, each into memory of its own.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}


def load_file(path: str | Path) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, not one of {sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = torch.tensor([], dtype=dtype).element_size()
        if end - begin != size * int(np.prod(shape, dtype=np.int64)) \
                or end > len(body):
            raise ValueError(f"{path}: tensor {name} has {end - begin} "
                             f"bytes for shape {shape}")
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(bytearray(body[begin:end]),
                                         dtype=dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor | np.ndarray],
              path: str | Path,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays of the supported
    dtypes) as one safetensors file. Tensors go in order of descending
    element size, then name, so every one starts aligned to its element;
    the header is padded with spaces to a multiple of 8 bytes."""
    ts = {k: (torch.from_numpy(np.ascontiguousarray(v))
              if isinstance(v, np.ndarray) else v).detach().cpu().contiguous()
          for k, v in tensors.items()}
    for k, t in ts.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {k}: dtype {t.dtype} is not supported")
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for k in order:
        t = ts[k]
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = ts[k]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def load_weights(model_dir: str | Path) -> Dict[str, torch.Tensor]:
    """A checkpoint directory's tensors: every ``*.safetensors`` file in it,
    else ``pytorch_model.bin`` (``torch.load(weights_only=True)``)."""
    model_dir = Path(model_dir)
    files = sorted(model_dir.glob("*.safetensors"))
    if files:
        out: Dict[str, torch.Tensor] = {}
        for f in files:
            out.update(load_file(f))
        return out
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights under {model_dir}")
