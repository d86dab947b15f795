"""Host decoding of dataset files: numpy versions of the JAX package's
``deeplearning4j_tpu.native`` readers the datasets use.

``read_idx`` (the MNIST family's IDX files), ``u8_to_f32`` (uint8 pixels
scaled to f32), ``read_csv`` (a numeric CSV as ``[rows, cols]`` f32) and
``u8hwc_to_f32chw`` (uint8 ``[N, H, W, C]`` to normalized f32 ``[N, C,
H, W]``). Each gives the JAX package's result bit for bit on the same
bytes: the f32 arithmetic is the C++ runtime's, operation for operation
(``native/src/io.cpp``, ``image.cpp``, built without FMA contraction).
The C++ host runtime itself is loaded with the rest of ``native/``
(ROADMAP.md A11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["read_csv", "read_idx", "u8_to_f32", "u8hwc_to_f32chw"]

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
               0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
               0x0E: np.dtype(">f8")}
_IDX_HOST = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
             0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}


def read_idx(path: str) -> np.ndarray:
    """Decode an IDX file (MNIST family) into a host-order array."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if len(magic) != 4 or magic[0] != 0 or magic[1] != 0:
            raise IOError(f"bad IDX file {path!r}")
        dtype, nd = magic[2], magic[3]
        if dtype not in _IDX_DTYPES or not 1 <= nd <= 8:
            raise IOError(f"bad IDX file {path!r}")
        shape = tuple(int.from_bytes(f.read(4), "big") for _ in range(nd))
        payload = f.read()
    dt = np.dtype(_IDX_DTYPES[dtype])
    if len(payload) != int(np.prod(shape)) * dt.itemsize:
        raise IOError(f"IDX payload mismatch in {path!r}")
    return np.frombuffer(payload, dtype=dt).reshape(shape).astype(
        _IDX_HOST[dtype])


def read_csv(path: str, skip_header=False,
             delimiter: str = ",") -> np.ndarray:
    """Parse a numeric CSV into a ``[rows, cols]`` float32 array (blank
    lines skipped; the first row sets ``cols``, a shorter row raises).
    ``skip_header``: a bool (one line) or a count."""
    skip = int(skip_header)
    with open(path) as f:
        rows = [ln.replace(delimiter, " ").split() for ln in f
                if ln.strip()][skip:]
    if not rows or not rows[0]:
        return np.empty((0, 0), np.float32)
    cols = len(rows[0])
    if any(len(r) < cols for r in rows):
        raise IOError(f"CSV parse failed for {path!r} (a short row)")
    return np.asarray([r[:cols] for r in rows], np.float32)


def u8_to_f32(arr: np.ndarray, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 data as float32 times ``scale`` (one f32 product an
    element)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    return arr.astype(np.float32) * np.float32(scale)


def u8hwc_to_f32chw(imgs: np.ndarray, scale: float = 1.0 / 255.0,
                    mean: Optional[np.ndarray] = None,
                    std: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 ``[N, H, W, C]`` to float32 ``[N, C, H, W]``: ``(x scale -
    mean[c]) (1 / std[c])`` in f32, a zero std taken as 1."""
    a = np.ascontiguousarray(imgs)
    if a.dtype != np.uint8 or a.ndim != 4:
        raise ValueError("expected uint8 [N,H,W,C] batch")
    c = a.shape[3]
    m = np.zeros(c, np.float32) if mean is None \
        else np.ascontiguousarray(mean, np.float32)
    s = np.ones(c, np.float32) if std is None \
        else np.ascontiguousarray(std, np.float32)
    if m.shape != (c,):
        raise ValueError(f"mean must be [{c}]")
    if s.shape != (c,):
        raise ValueError(f"std must be [{c}]")
    inv = np.float32(1.0) / np.where(s == 0, np.float32(1.0), s)
    x = (a.astype(np.float32) * np.float32(scale) - m) * inv
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))
