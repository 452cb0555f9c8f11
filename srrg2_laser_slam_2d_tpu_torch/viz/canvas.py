"""Offline drawing canvas in place of the reference's live viewer, with the
same draw hooks: ``push_matrix`` / ``mult_matrix`` / ``pop_matrix``,
``push_color`` / ``push_point_size`` / ``pop_attribute``, ``set_color`` /
``set_point_size``, ``put_points`` / ``put_cloud`` / ``put_segments`` /
``put_reference_system`` / ``put_trajectory``, ``flush(path) -> path`` and
``close``. Counterpart of ``srrg2_laser_slam_2d_tpu/viz/canvas.py``.

The JAX package draws with matplotlib; this canvas needs numpy alone. It
keeps the primitives in world coordinates, and ``flush`` fits them into a
square image (equal axes, white background), rasterizes them and writes an
RGB PNG itself (``zlib`` and ``struct``: signature, IHDR, IDAT, IEND). It
renders the same primitives, not the same pixels, and writes no title text.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

DPI = 120          # pixels per inch, as the JAX canvas saves its figure
MARGIN = 0.04      # share of the image left blank on each side

# the named colors the draw hooks use (matplotlib's values)
_NAMED = {"black": (0, 0, 0), "red": (255, 0, 0), "green": (0, 128, 0),
          "gray": (128, 128, 128), "magenta": (255, 0, 255)}


def parse_color(color: str) -> tuple[int, int, int]:
    """'#rrggbb' or a name of ``_NAMED``."""
    if color.startswith("#") and len(color) == 7:
        return tuple(int(color[i:i + 2], 16) for i in (1, 3, 5))
    if color in _NAMED:
        return _NAMED[color]
    raise ValueError(f"unknown color {color!r}")


def _pose_to_mat(pose) -> np.ndarray:
    x, y, t = np.asarray(pose, np.float64)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, x], [s, c, y], [0, 0, 1]])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an [h, w, 3] uint8 image as an RGB PNG (filter 0 on every row)."""
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image, np.uint8).reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


class Canvas:
    def __init__(self, title: str = "canvas", figsize=(8, 8)):
        self.title = title
        self.size = (int(figsize[0] * DPI), int(figsize[1] * DPI))   # (w, h) pixels
        self._matrix_stack = [np.eye(3)]
        self._color = "#1f77b4"
        self._point_size = 2.0
        self._attr_stack: list = []
        # ("points", xy [N, 2], rgb, side px) / ("lines", a [N, 2], b [N, 2], rgb, width px)
        self._items: list = []

    # -- transform stack -----------------------------------------------------
    def push_matrix(self) -> None:
        self._matrix_stack.append(self._matrix_stack[-1].copy())

    def mult_matrix(self, pose) -> None:
        self._matrix_stack[-1] = self._matrix_stack[-1] @ _pose_to_mat(pose)

    def pop_matrix(self) -> None:
        self._matrix_stack.pop()

    # -- attributes ----------------------------------------------------------
    def push_color(self) -> None:
        self._attr_stack.append(("color", self._color))

    def push_point_size(self) -> None:
        self._attr_stack.append(("size", self._point_size))

    def pop_attribute(self) -> None:
        kind, val = self._attr_stack.pop()
        if kind == "color":
            self._color = val
        else:
            self._point_size = val

    def set_color(self, color) -> None:
        self._color = color

    def set_point_size(self, size: float) -> None:
        self._point_size = size

    # -- primitives ----------------------------------------------------------
    def _apply(self, pts: np.ndarray) -> np.ndarray:
        m = self._matrix_stack[-1]
        return pts @ m[:2, :2].T + m[:2, 2]

    def _lines(self, a: np.ndarray, b: np.ndarray, color, width_pt: float) -> None:
        if len(a):
            self._items.append(("lines", a, b, parse_color(color),
                                max(1, int(round(width_pt * DPI / 72)))))

    def put_points(self, xy, valid=None, color=None) -> None:
        """Points [N, 2] (those where ``valid``) in the current frame; the
        point size is a marker area in points squared, as matplotlib's."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        if valid is not None:
            xy = xy[np.asarray(valid, bool)[: len(xy)]]
        if len(xy) == 0:
            return
        side = max(1, int(round(np.sqrt(self._point_size) * DPI / 72)))
        self._items.append(("points", self._apply(xy), parse_color(color or self._color), side))

    def put_cloud(self, cloud, color=None) -> None:
        """A ``Cloud``'s valid points (host or device tensors)."""
        self.put_points(_host(cloud.xy), _host(cloud.valid), color)

    def put_segments(self, starts, ends, color=None) -> None:
        a = self._apply(np.asarray(starts, np.float64).reshape(-1, 2))
        b = self._apply(np.asarray(ends, np.float64).reshape(-1, 2))
        self._lines(a, b, color or self._color, 0.5)

    def put_reference_system(self, scale: float = 0.25) -> None:
        o = self._apply(np.zeros((1, 2)))
        self._lines(o, self._apply(np.array([[scale, 0.0]])), "red", 1.5)
        self._lines(o, self._apply(np.array([[0.0, scale]])), "green", 1.5)

    def put_trajectory(self, poses, color="black") -> None:
        p = self._apply(np.asarray(poses, np.float64)[:, :2])
        self._lines(p[:-1], p[1:], color, 1.0)

    # -- output --------------------------------------------------------------
    def render(self) -> np.ndarray:
        """The [h, w, 3] uint8 image of everything put so far."""
        w, h = self.size
        img = np.full((h, w, 3), 255, np.uint8)
        pts = [it[1] for it in self._items if it[0] == "points"]
        pts += [np.concatenate([it[1], it[2]]) for it in self._items if it[0] == "lines"]
        if not pts:
            return img
        allp = np.concatenate(pts)
        lo, hi = allp.min(axis=0), allp.max(axis=0)
        span = max(float((hi - lo).max()), 1e-9)
        scale = (1 - 2 * MARGIN) * min(w, h) / span      # pixels per metre, equal axes
        center = 0.5 * (lo + hi)

        def to_px(p):
            col = (p[:, 0] - center[0]) * scale + 0.5 * w
            row = 0.5 * h - (p[:, 1] - center[1]) * scale
            return col, row

        for it in self._items:
            if it[0] == "points":
                col, row = to_px(it[1])
                rgb, side = it[2], it[3]
            else:
                a, b, rgb, side = it[1], it[2], it[3], it[4]
                (ca, ra), (cb, rb) = to_px(a), to_px(b)
                # one sample a pixel along each segment
                n = np.ceil(np.maximum(np.abs(cb - ca), np.abs(rb - ra))).astype(np.int64) + 1
                seg = np.repeat(np.arange(len(n)), n)
                frac = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) \
                    / np.maximum(np.repeat(n, n) - 1, 1)
                col = ca[seg] + frac * (cb - ca)[seg]
                row = ra[seg] + frac * (rb - ra)[seg]
            c0 = np.round(col).astype(np.int64) - side // 2
            r0 = np.round(row).astype(np.int64) - side // 2
            for dr in range(side):
                for dc in range(side):
                    r, c = r0 + dr, c0 + dc
                    inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
                    img[r[inside], c[inside]] = rgb
        return img

    def flush(self, path: str | None = None) -> str:
        """Render and write the PNG (``<title>.png`` by default); returns
        its path."""
        out = path or f"{self.title}.png"
        write_png(out, self.render())
        return out

    def close(self) -> None:
        self._items = []


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
