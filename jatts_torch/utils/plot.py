"""Plots of training artifacts (counterpart of jatts_tpu/utils/plot.py), as
PNG files written without matplotlib.

A matrix is drawn cell for cell (each cell ``SCALE`` x ``SCALE`` pixels)
through a viridis-like colour map, min to max of its finite values, the
first row at the bottom (``origin="lower"``); a mel ``[T, n_mels]`` is
drawn transposed, time along x. :func:`plot_1d` draws the series as a
line on a white canvas. The title goes into the PNG's ``Title`` text
chunk. The PNG is 8-bit RGB, one zlib stream of unfiltered rows.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SCALE = 2
LINE_HEIGHT = 128
# viridis at 0, 1/4, 1/2, 3/4 and 1, linearly interpolated between
_ANCHORS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]], np.float64)


def _at_least_1col(m: np.ndarray) -> np.ndarray:
    """Zero-length sequences (degenerate eval rows) are padded to one cell,
    so the artifact still renders."""
    m = np.atleast_2d(np.asarray(m))
    if m.shape[0] == 0:
        m = np.zeros((1, max(m.shape[1], 1)), m.dtype)
    if m.shape[1] == 0:
        m = np.zeros((m.shape[0], 1), m.dtype)
    return m


def colormap(m: np.ndarray) -> np.ndarray:
    """``[H, W]`` values -> ``[H, W, 3]`` uint8, min to max of the finite
    values (a constant matrix takes the lowest colour, NaN the highest)."""
    m = np.asarray(m, np.float64)
    finite = np.isfinite(m)
    lo, hi = (m[finite].min(), m[finite].max()) if finite.any() else (0.0, 0.0)
    u = np.where(finite, (m - lo) / (hi - lo) if hi > lo else 0.0, 1.0)
    pos = np.clip(u, 0.0, 1.0) * (len(_ANCHORS) - 1)
    i = np.minimum(pos.astype(np.int64), len(_ANCHORS) - 2)
    frac = (pos - i)[..., None]
    rgb = _ANCHORS[i] * (1.0 - frac) + _ANCHORS[i + 1] * frac
    return np.rint(rgb).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def png_bytes(rgb: np.ndarray, title: str = "") -> bytes:
    """An 8-bit RGB PNG of ``rgb [H, W, 3]`` uint8, the first row on top."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    if title:
        out += _chunk(b"tEXt", b"Title\x00" + title.encode("latin-1", "replace"))
    return out + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


def _save(rgb: np.ndarray, path: str, title: str = "") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(rgb, title))


def _image(m: np.ndarray) -> np.ndarray:
    """A matrix as pixels: row 0 at the bottom, each cell SCALE x SCALE."""
    rgb = colormap(_at_least_1col(m))[::-1]
    return np.repeat(np.repeat(rgb, SCALE, axis=0), SCALE, axis=1)


def plot_mel(mel: np.ndarray, path: str, title: str = "") -> None:
    _save(_image(_at_least_1col(mel).T), path, title)


def plot_generated_and_ref(gen: np.ndarray, ref: np.ndarray, path: str) -> None:
    """The generated mel above the reference, each on its own scale, on a
    common width, a white band between them."""
    top, bottom = _image(_at_least_1col(gen).T), _image(_at_least_1col(ref).T)
    w = max(top.shape[1], bottom.shape[1])

    def pad(img):
        return np.pad(img, ((0, 0), (0, w - img.shape[1]), (0, 0)), constant_values=255)

    band = np.full((2 * SCALE, w, 3), 255, np.uint8)
    _save(np.concatenate([pad(top), band, pad(bottom)]), path, "generated / reference")


def plot_attention(attn: np.ndarray, path: str, title: str = "") -> None:
    _save(_image(attn), path, title)


def plot_1d(x: np.ndarray, path: str, title: str = "") -> None:
    """The series as a dark line, min at the bottom and max at the top of a
    LINE_HEIGHT-pixel canvas, SCALE pixels a sample; consecutive samples
    joined by a vertical run."""
    x = np.asarray(x, np.float64).reshape(-1)
    if x.size == 0:
        x = np.zeros(1)
    finite = np.isfinite(x)
    lo, hi = (x[finite].min(), x[finite].max()) if finite.any() else (0.0, 0.0)
    u = np.where(finite, (x - lo) / (hi - lo) if hi > lo else 0.5, 0.5)
    rows = (LINE_HEIGHT - 1) - np.rint(u * (LINE_HEIGHT - 1)).astype(np.int64)
    w = x.size * SCALE
    canvas = np.full((LINE_HEIGHT, w, 3), 255, np.uint8)
    for i, r in enumerate(rows):
        prev = rows[i - 1] if i else r
        a, b = min(prev, r), max(prev, r)
        canvas[a:b + 1, i * SCALE:(i + 1) * SCALE] = (31, 119, 180)
    _save(canvas, path, title)


def plot_histogram(values: np.ndarray, path: str, bins: int = 100, value_range=None, title: str = "") -> None:
    """``np.histogram(values, bins, value_range)`` as bars on a white
    LINE_HEIGHT-pixel canvas, 2 * SCALE pixels a bin, the tallest bin full
    height."""
    counts, _ = np.histogram(np.asarray(values, np.float64).reshape(-1), bins=bins, range=value_range)
    top = max(int(counts.max()), 1) if counts.size else 1
    heights = np.rint(counts / top * (LINE_HEIGHT - 1)).astype(np.int64)
    width = 2 * SCALE
    canvas = np.full((LINE_HEIGHT, bins * width, 3), 255, np.uint8)
    for i, h in enumerate(heights):
        if counts[i]:
            canvas[LINE_HEIGHT - 1 - h:, i * width:(i + 1) * width - 1] = (31, 119, 180)
    _save(canvas, path, title)
