"""A small raster plotter for the report figures: numpy canvas, zlib PNG.

Covers what the eight sampleqc figures draw — histograms (filled or
step), lines, box plots, vertical / horizontal lines and spans, grid,
ticks, axis labels, titles, legends and text in a built-in 3x5 bitmap
font (upper-case letters, digits and common punctuation; lower case
prints as upper case) — and nothing more. Artists are collected per
axes and drawn at save time, so unset limits autoscale to the data.
"""

import struct
import zlib

import numpy as np

COLORS = {
    "red": (214, 39, 40), "green": (44, 160, 44), "blue": (31, 119, 180),
    "orange": (255, 127, 14), "gray": (127, 127, 127),
    "royalblue": (65, 105, 225), "yellow": (255, 255, 0),
    "black": (0, 0, 0), "white": (255, 255, 255),
    "purple": (148, 103, 189), "brown": (140, 86, 75),
}
CYCLE = ("blue", "orange", "green", "red", "purple", "brown")

# 3x5 glyphs, rows top to bottom, 3 bits each
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001010010", "8": "111101111101111",
    "9": "111101111001111", "A": "010101111101101", "B": "110101110101110",
    "C": "011100100100011", "D": "110101101101110", "E": "111100110100111",
    "F": "111100110100100", "G": "011100101101011", "H": "101101111101101",
    "I": "111010010010111", "J": "001001001101010", "K": "101101110101101",
    "L": "100100100100111", "M": "101111111101101", "N": "110101101101101",
    "O": "010101101101010", "P": "110101110100100", "Q": "010101101110011",
    "R": "110101110101101", "S": "011100010001110", "T": "111010010010010",
    "U": "101101101101111", "V": "101101101101010", "W": "101101111111101",
    "X": "101101010101101", "Y": "101101010010010", "Z": "111001010100111",
    ".": "000000000000010", ",": "000000000010100", ":": "000010000010000",
    "-": "000000111000000", "+": "000010111010000", "=": "000111000111000",
    "(": "001010010010001", ")": "100010010010100", "%": "101001010100101",
    "/": "001001010100100", "'": "010010000000000", "_": "000000000000111",
    " ": "000000000000000", "?": "111001011000010",
}
_SCALE = 2                      # font pixels per glyph bit
CHAR_W, CHAR_H = 4 * _SCALE, 6 * _SCALE


def _rgb(color):
    if isinstance(color, str):
        return np.array(COLORS[color], float)
    c = np.asarray(color, float)
    return c * 255.0 if c.max() <= 1.0 else c


def write_png(path, rgb):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    H, W, _ = rgb.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          rgb.reshape(H, W * 3)], axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def _nice_ticks(lo, hi, n=6):
    span = hi - lo
    if not np.isfinite(span) or span <= 0:
        return np.array([lo])
    raw = span / n
    mag = 10 ** np.floor(np.log10(raw))
    step = mag * min((s for s in (1, 2, 5, 10) if s * mag >= raw))
    first = np.ceil(lo / step) * step
    return np.arange(first, hi + step * 1e-9, step)


def _fmt(v):
    if v == int(v) and abs(v) < 1e7:
        return "%d" % v
    return ("%.3g" % v).upper()


class Canvas:
    def __init__(self, width, height):
        self.px = np.full((height, width, 3), 255.0)

    @property
    def H(self):
        return self.px.shape[0]

    @property
    def W(self):
        return self.px.shape[1]

    def rect(self, x0, y0, x1, y1, color, alpha=1.0):
        x0, x1 = sorted((int(round(x0)), int(round(x1))))
        y0, y1 = sorted((int(round(y0)), int(round(y1))))
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, self.W - 1), min(y1, self.H - 1)
        if x1 < x0 or y1 < y0:
            return
        sl = self.px[y0:y1 + 1, x0:x1 + 1]
        sl[...] = sl * (1 - alpha) + _rgb(color) * alpha

    def line(self, xs, ys, color, width=1, dashed=False, alpha=1.0,
             clip=None):
        xs = np.asarray(xs, float)
        ys = np.asarray(ys, float)
        ok = np.isfinite(xs) & np.isfinite(ys)
        if ok.sum() < 1:
            return
        pts_x, pts_y = [], []
        for i in range(len(xs) - 1):
            if not (ok[i] and ok[i + 1]):
                continue
            n = int(max(abs(xs[i + 1] - xs[i]), abs(ys[i + 1] - ys[i]),
                        1)) + 1
            t = np.linspace(0.0, 1.0, min(n, 20000))
            pts_x.append(xs[i] + (xs[i + 1] - xs[i]) * t)
            pts_y.append(ys[i] + (ys[i + 1] - ys[i]) * t)
        if not pts_x:
            return
        px = np.concatenate(pts_x)
        py = np.concatenate(pts_y)
        if dashed:
            d = np.concatenate([[0.0], np.cumsum(np.hypot(
                np.diff(px), np.diff(py)))])
            keep = (d // 6) % 2 == 0
            px, py = px[keep], py[keep]
        px = np.round(px).astype(int)
        py = np.round(py).astype(int)
        x0, y0, x1, y1 = clip or (0, 0, self.W - 1, self.H - 1)
        c = _rgb(color)
        for off in range(width):
            for ax, ay in ((off, 0), (0, off)):
                qx, qy = px + ax, py + ay
                m = (qx >= x0) & (qx <= x1) & (qy >= y0) & (qy <= y1)
                sl = self.px[qy[m], qx[m]]
                self.px[qy[m], qx[m]] = sl * (1 - alpha) + c * alpha

    def text(self, x, y, s, color="black", anchor="left", vertical=False):
        """Draw s with its top-left (anchor left), centre or right end at
        pixel (x, y); vertical text runs bottom to top."""
        s = s.upper()
        w = len(s) * CHAR_W
        if anchor == "center":
            x -= w // 2 if not vertical else 0
            y += w // 2 if vertical else 0
        elif anchor == "right":
            x -= w if not vertical else 0
        c = _rgb(color)
        for k, ch in enumerate(s):
            g = _GLYPHS.get(ch, _GLYPHS["?"])
            for r in range(5):
                for col in range(3):
                    if g[r * 3 + col] != "1":
                        continue
                    if vertical:
                        gx = int(x) + r * _SCALE
                        gy = int(y) - (k * CHAR_W + col * _SCALE) - _SCALE
                    else:
                        gx = int(x) + k * CHAR_W + col * _SCALE
                        gy = int(y) + r * _SCALE
                    if 0 <= gx and gx + _SCALE <= self.W and 0 <= gy \
                            and gy + _SCALE <= self.H:
                        self.px[gy:gy + _SCALE, gx:gx + _SCALE] = c


class Axes:
    def __init__(self):
        self.artists = []
        self.xlim = self.ylim = None
        self.xlabel = self.ylabel = self.title = ""
        self.xticks = None
        self.show_grid = False
        self._ncolor = 0

    def _next_color(self, color):
        if color is not None:
            return color
        c = CYCLE[self._ncolor % len(CYCLE)]
        self._ncolor += 1
        return c

    def grid(self, on=True):
        self.show_grid = on

    def set_xlim(self, lo, hi):
        self.xlim = (float(lo), float(hi))

    def set_ylim(self, lo, hi):
        self.ylim = (float(lo), float(hi))

    def get_ylim(self):
        return self.ylim or self._data_lims()[1]

    def get_xlim(self):
        return self.xlim or self._data_lims()[0]

    def hist(self, values, bins, color=None, alpha=1.0, density=False,
             step=False):
        v = np.asarray(values, float)
        v = v[np.isfinite(v)]
        cnt, edges = np.histogram(v, bins=bins)
        if density and cnt.sum() > 0:
            cnt = cnt / (cnt.sum() * np.diff(edges))
        self.artists.append(("hist", edges, cnt.astype(float),
                             self._next_color(color), alpha, step))
        return cnt, edges

    def plot(self, x, y, color=None, label=None, width=2):
        self.artists.append(("line", np.asarray(x, float),
                             np.asarray(y, float),
                             self._next_color(color), label, width))

    def axvline(self, x, color="black", dashed=False, alpha=1.0,
                width=2):
        self.artists.append(("vline", float(x), color, dashed, alpha,
                             width))

    def axhline(self, y, color="black", alpha=1.0, width=1):
        self.artists.append(("hline", float(y), color, alpha, width))

    def axvspan(self, x0, x1, color, alpha):
        self.artists.append(("vspan", float(x0), float(x1), color, alpha))

    def axhspan(self, y0, y1, color, alpha):
        self.artists.append(("hspan", float(y0), float(y1), color, alpha))

    def boxplot(self, groups):
        """Boxes at x = 1..n: quartiles, median, whiskers to the last
        point within 1.5 IQR, '+' outliers (matplotlib's defaults)."""
        stats = []
        for g in groups:
            g = np.asarray(g, float)
            g = g[np.isfinite(g)]
            if len(g) == 0:
                stats.append(None)
                continue
            q1, med, q3 = np.percentile(g, [25, 50, 75])
            iqr = q3 - q1
            inside = g[(g >= q1 - 1.5 * iqr) & (g <= q3 + 1.5 * iqr)]
            lo = inside.min() if len(inside) else q1
            hi = inside.max() if len(inside) else q3
            out = g[(g < lo) | (g > hi)]
            stats.append((q1, med, q3, lo, hi, out))
        self.artists.append(("box", stats))
        if self.xlim is None:
            self.xlim = (0.5, len(groups) + 0.5)

    def text(self, x, y, s, color="black", anchor="left"):
        self.artists.append(("text", float(x), float(y), s, color,
                             anchor))

    def _data_lims(self):
        xs, ys = [], []
        for a in self.artists:
            if a[0] == "hist":
                xs += [a[1][0], a[1][-1]]
                ys += [0.0, float(a[2].max()) if len(a[2]) else 1.0]
            elif a[0] == "line":
                ok = np.isfinite(a[1]) & np.isfinite(a[2])
                if ok.any():
                    xs += [a[1][ok].min(), a[1][ok].max()]
                    ys += [a[2][ok].min(), a[2][ok].max()]
            elif a[0] == "box":
                for s in a[1]:
                    if s is not None:
                        vals = [s[3], s[4]] + list(s[5])
                        ys += [min(vals), max(vals)]
                xs += [0.5, len(a[1]) + 0.5]
            elif a[0] == "vline":
                xs.append(a[1])
        xl = (min(xs), max(xs)) if xs else (0.0, 1.0)
        yl = (min(ys), max(ys)) if ys else (0.0, 1.0)
        if yl[1] > yl[0]:
            pad = 0.05 * (yl[1] - yl[0])
            yl = (yl[0] - pad if yl[0] != 0 else 0.0, yl[1] + pad)
        else:
            yl = (yl[0] - 1.0, yl[1] + 1.0)
        if xl[1] <= xl[0]:
            xl = (xl[0] - 1.0, xl[1] + 1.0)
        return xl, yl

    # ------------------------------------------------------------------
    def render(self, cv, box):
        """Draw into canvas cv inside pixel box (x0, y0, x1, y1)."""
        X0, Y0, X1, Y1 = box
        (dx0, dx1), (dy0, dy1) = self._data_lims()
        xlo, xhi = self.xlim or (dx0, dx1)
        ylo, yhi = self.ylim or (dy0, dy1)
        if xhi == xlo:
            xhi = xlo + 1.0
        if yhi == ylo:
            yhi = ylo + 1.0

        def tx(x):
            return X0 + (np.asarray(x, float) - xlo) / (xhi - xlo) \
                * (X1 - X0)

        def ty(y):
            return Y1 - (np.asarray(y, float) - ylo) / (yhi - ylo) \
                * (Y1 - Y0)

        clip = (X0, Y0, X1, Y1)
        for a in self.artists:
            if a[0] == "vspan":
                cv.rect(max(tx(a[1]), X0), Y0, min(tx(a[2]), X1), Y1,
                        a[3], a[4])
            elif a[0] == "hspan":
                cv.rect(X0, max(ty(a[2]), Y0), X1, min(ty(a[1]), Y1),
                        a[3], a[4])
        if self.xticks is not None:
            xt, xtl = self.xticks
        else:
            xt = _nice_ticks(min(xlo, xhi), max(xlo, xhi))
            xtl = [_fmt(v) for v in xt]
        yt = _nice_ticks(ylo, yhi)
        if self.show_grid:
            for v in xt:
                cv.line([tx(v)] * 2, [Y0, Y1], (220, 220, 220), clip=clip)
            for v in yt:
                cv.line([X0, X1], [ty(v)] * 2, (220, 220, 220), clip=clip)
        legend = []
        for a in self.artists:
            kind = a[0]
            if kind == "hist":
                _, edges, cnt, color, alpha, step = a
                if step:
                    xs = np.repeat(edges, 2)[1:-1]
                    ys = np.repeat(cnt, 2)
                    cv.line(tx(xs), ty(ys), color, width=2, alpha=alpha,
                            clip=clip)
                else:
                    for e0, e1, c in zip(edges[:-1], edges[1:], cnt):
                        if c > 0:
                            cv.rect(max(tx(e0), X0), max(ty(c), Y0),
                                    min(tx(e1), X1), Y1, color,
                                    max(alpha, 0.35))
            elif kind == "line":
                _, x, y, color, label, width = a
                cv.line(tx(x), ty(y), color, width=width, clip=clip)
                if label:
                    legend.append((label, color))
            elif kind == "box":
                for i, s in enumerate(a[1]):
                    if s is None:
                        continue
                    q1, med, q3, lo, hi, out = s
                    xc = tx(i + 1)
                    hw = max((tx(1.25) - tx(1.0)), 3)
                    for yv in (q1, q3):
                        cv.line([xc - hw, xc + hw], [ty(yv)] * 2,
                                "blue", clip=clip)
                    cv.line([xc - hw] * 2, [ty(q1), ty(q3)], "blue",
                            clip=clip)
                    cv.line([xc + hw] * 2, [ty(q1), ty(q3)], "blue",
                            clip=clip)
                    cv.line([xc - hw, xc + hw], [ty(med)] * 2, "orange",
                            width=2, clip=clip)
                    cv.line([xc, xc], [ty(q3), ty(hi)], "black", clip=clip)
                    cv.line([xc, xc], [ty(q1), ty(lo)], "black", clip=clip)
                    for yv in (lo, hi):
                        cv.line([xc - hw / 2, xc + hw / 2], [ty(yv)] * 2,
                                "black", clip=clip)
                    for yv in out[:2000]:
                        py = ty(yv)
                        cv.line([xc - 2, xc + 2], [py, py], "black",
                                clip=clip)
                        cv.line([xc, xc], [py - 2, py + 2], "black",
                                clip=clip)
            elif kind == "vline":
                _, x, color, dashed, alpha, width = a
                cv.line([tx(x)] * 2, [Y0, Y1], color, width=width,
                        dashed=dashed, alpha=alpha, clip=clip)
            elif kind == "hline":
                _, y, color, alpha, width = a
                cv.line([X0, X1], [ty(y)] * 2, color, width=width,
                        alpha=alpha, clip=clip)
        for a in self.artists:
            if a[0] == "text":
                _, x, y, s, color, anchor = a
                cv.text(tx(x), ty(y) - CHAR_H, s, color, anchor=anchor)
        # frame, ticks, labels
        cv.line([X0, X1, X1, X0, X0], [Y0, Y0, Y1, Y1, Y0], "black")
        for v, lab in zip(xt, xtl):
            px = tx(v)
            if min(X0, X1) - 1 <= px <= max(X0, X1) + 1:
                cv.line([px, px], [Y1, Y1 + 4], "black")
                cv.text(px, Y1 + 7, lab, anchor="center")
        for v in yt:
            py = ty(v)
            if Y0 - 1 <= py <= Y1 + 1:
                cv.line([X0 - 4, X0], [py, py], "black")
                cv.text(X0 - 7, py - CHAR_H // 2, _fmt(v), anchor="right")
        if self.xlabel:
            cv.text((X0 + X1) / 2, Y1 + 7 + 2 * CHAR_H, self.xlabel,
                    anchor="center")
        if self.ylabel:
            cv.text(X0 - 7 - 8 * CHAR_W, (Y0 + Y1) / 2, self.ylabel,
                    anchor="center", vertical=True)
        if self.title:
            cv.text((X0 + X1) / 2, Y0 - 2 * CHAR_H, self.title,
                    anchor="center")
        for k, (label, color) in enumerate(legend):
            ly = Y0 + 8 + k * (CHAR_H + 6)
            lx = X1 - 8 - len(label) * CHAR_W
            cv.line([lx - 26, lx - 6], [ly + CHAR_H // 2] * 2, color,
                    width=2)
            cv.text(lx, ly, label)


class Figure:
    """One or more side-by-side panels; save() renders and writes."""

    def __init__(self, width=640, height=480, ncols=1):
        self.width, self.height = width, height
        self.axes = [Axes() for _ in range(ncols)]
        self.notes = []

    def note(self, fx, fy, s, background="yellow"):
        """Figure-level text at fractional position (fx, fy)."""
        self.notes.append((fx, fy, s, background))

    def save(self, path):
        cv = Canvas(self.width, self.height)
        n = len(self.axes)
        pw = self.width // n
        for i, ax in enumerate(self.axes):
            left = i * pw + 11 * CHAR_W + 8
            box = (left, 4 * CHAR_H, (i + 1) * pw - 16,
                   self.height - 5 * CHAR_H)
            ax.render(cv, box)
        for fx, fy, s, bg in self.notes:
            x = fx * self.width
            y = (1 - fy) * self.height
            cv.rect(x - 2, y - 2, x + len(s) * CHAR_W + 2, y + CHAR_H + 2,
                    bg)
            cv.text(x, y, s)
        write_png(path, np.clip(np.round(cv.px), 0, 255).astype(np.uint8))
