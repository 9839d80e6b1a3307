"""Plotting: predictive bands and the MAP objective's trace.

Counterpart of ``_save``, ``plot_mean_and_ci``, ``plot_posterior`` and
``plot_target_trace`` in the JAX package's ``viz.py`` (reference
``Utility/visualization.py``, ``Utility/posterior_analysis.py:102-106``),
written with matplotlib's Agg backend.  Where matplotlib is not installed
(as on a bare CUDA machine) the two figures are still written: the same
panels (band, mean, observations; the trace) drawn into a numpy raster and
encoded as PNG with the standard library, without text or axes.  The other
figures of the JAX module are not ported yet.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    plt = None


def _save(fig, path):
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_mean_and_ci(ax, x, mean, lb, ub, color_mean="b", color_shading="r"):
    """(posterior_analysis.py:102-106)"""
    ax.fill_between(x, ub, lb, color=color_shading, alpha=0.5,
                    label="predictive 95% interval")
    ax.plot(x, mean, color=color_mean, label="predictive mean")


def plot_posterior(path, grid, percentiles, x=None, y=None, x_test=None, y_test=None,
                   attributes=None):
    """Predictive bands per task with train/test overlays.

    ``percentiles``: (G, 3, M) as returned by ``predict.gnmgp.predict_map``.
    Mirrors ``visualization.Plot_posterior{,_trainandtest}`` (:21-107).
    """
    pct = np.asarray(percentiles)
    g, _, m = pct.shape
    grid = np.asarray(grid)
    if plt is None:
        canvas = _Raster(m)
        for j in range(m):
            series = [pct[:, 0, j], pct[:, 2, j]]
            series += [np.asarray(y)[:, j]] if x is not None and y is not None else []
            series += [np.asarray(y_test)[:, j]] if x_test is not None and y_test is not None else []
            canvas.limits(j, grid, np.concatenate(series))
            canvas.band(j, grid, pct[:, 0, j], pct[:, 2, j], (255, 128, 128))
            canvas.line(j, grid, pct[:, 1, j], (0, 0, 255))
            if x is not None and y is not None:
                canvas.points(j, np.asarray(x), np.asarray(y)[:, j], (0, 0, 0))
            if x_test is not None and y_test is not None:
                canvas.points(j, np.asarray(x_test), np.asarray(y_test)[:, j], (0, 128, 0))
        canvas.save(path)
        return
    attributes = attributes or [f"Dim {i+1}" for i in range(m)]
    fig, axes = plt.subplots(m, 1, figsize=(8, 3 * m), squeeze=False)
    for j in range(m):
        ax = axes[j, 0]
        plot_mean_and_ci(ax, grid, pct[:, 1, j], pct[:, 0, j], pct[:, 2, j])
        if x is not None and y is not None:
            ax.scatter(np.asarray(x), np.asarray(y)[:, j], s=8, c="k", label="train")
        if x_test is not None and y_test is not None:
            ax.scatter(np.asarray(x_test), np.asarray(y_test)[:, j], s=10, c="g",
                       marker="^", label="test")
        ax.set_title(attributes[j])
        ax.legend(loc="best", fontsize=7)
    _save(fig, path)


def plot_target_trace(path, target_hist):
    """Objective trace (Nonseparable_model.py:196-202)."""
    hist = np.asarray(target_hist)
    if plt is None:
        canvas = _Raster(1)
        steps = np.arange(hist.shape[0], dtype=float)
        canvas.limits(0, steps, hist)
        canvas.line(0, steps, hist, (0, 0, 255))
        canvas.save(path)
        return
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(hist)
    ax.set_xlabel("iteration")
    ax.set_ylabel("log posterior")
    _save(fig, path)


class _Raster:
    """``rows`` framed panels stacked vertically in an RGB raster."""

    W, H, PAD = 800, 300, 12

    def __init__(self, rows: int):
        self.img = np.full((self.H * rows, self.W, 3), 255, np.uint8)
        self.lims = [(0.0, 1.0, 0.0, 1.0)] * rows
        for r in range(rows):
            top, bottom = r * self.H + self.PAD, (r + 1) * self.H - self.PAD - 1
            self.img[[top, bottom], self.PAD : self.W - self.PAD] = 0
            self.img[top : bottom + 1, [self.PAD, self.W - self.PAD - 1]] = 0

    def limits(self, r, xs, ys):
        xs, ys = np.asarray(xs, float), np.asarray(ys, float)
        ys = ys[np.isfinite(ys)]
        x0, x1 = float(np.min(xs)), float(np.max(xs))
        y0, y1 = (float(np.min(ys)), float(np.max(ys))) if ys.size else (0.0, 1.0)
        self.lims[r] = (x0, x1 if x1 > x0 else x0 + 1.0, y0, y1 if y1 > y0 else y0 + 1.0)

    def _px(self, r, xs, ys):
        """Pixel columns and rows of data points inside panel ``r``'s frame."""
        x0, x1, y0, y1 = self.lims[r]
        inner_w, inner_h = self.W - 4 * self.PAD, self.H - 4 * self.PAD
        cols = 2 * self.PAD + (np.asarray(xs, float) - x0) / (x1 - x0) * (inner_w - 1)
        rows = r * self.H + 2 * self.PAD + (y1 - np.asarray(ys, float)) / (y1 - y0) * (inner_h - 1)
        return np.round(cols), np.round(rows)

    def _columns(self, r, xs):
        c_lo, _ = self._px(r, [np.min(xs)], [0.0])
        c_hi, _ = self._px(r, [np.max(xs)], [0.0])
        cols = np.arange(int(c_lo[0]), int(c_hi[0]) + 1)
        x0, x1, _, _ = self.lims[r]
        return cols, x0 + (cols - 2 * self.PAD) / (self.W - 4 * self.PAD - 1) * (x1 - x0)

    def _fill(self, r, cols, top, bottom, color):
        for c, a, b in zip(cols, top, bottom):
            if np.isfinite(a) and np.isfinite(b):
                lo, hi = int(min(a, b)), int(max(a, b))
                self.img[max(lo, r * self.H) : min(hi, (r + 1) * self.H - 1) + 1, c] = color

    def band(self, r, xs, lo, hi, color):
        cols, xv = self._columns(r, xs)
        _, top = self._px(r, xv, np.interp(xv, xs, hi))
        _, bottom = self._px(r, xv, np.interp(xv, xs, lo))
        self._fill(r, cols, top, bottom, color)

    def line(self, r, xs, ys, color):
        cols, xv = self._columns(r, xs)
        _, rows = self._px(r, xv, np.interp(xv, xs, ys))
        prev = np.concatenate([rows[:1], rows[:-1]])  # join each column to the last
        self._fill(r, cols, prev, rows, color)

    def points(self, r, xs, ys, color):
        cols, rows = self._px(r, xs, ys)
        for c, w in zip(cols, rows):
            if np.isfinite(c) and np.isfinite(w):
                self.img[max(int(w) - 1, 0) : int(w) + 2, max(int(c) - 1, 0) : int(c) + 2] = color

    def save(self, path):
        h, w, _ = self.img.shape
        raw = b"".join(b"\x00" + row.tobytes() for row in self.img)

        def chunk(tag, data):
            return (struct.pack(">I", len(data)) + tag + data
                    + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
