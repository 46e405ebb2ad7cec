"""Class-average viewer and selector of the port
(thunder_tpu.cli.stackview; THUNDER's Qt GUI,
gui/thunder_stackview/MainWnd.h:55-92): PNG contact sheets, .thu class
filtering, and an interactive terminal selector (``view``) with the GUI's
operations (paging, contrast, occupancy / resolution sorting, per-class
select, save list / save particles) as character-ramp thumbnails in
curses (runs over ssh; no Qt).  Host numpy only; stacks and tables go
through the port's io/.

    python -m thunder_tpu_torch.cli.stackview show -i Reference_Round_010.mrcs -o sheet.png
    python -m thunder_tpu_torch.cli.stackview info -i Reference_Round_010.mrcs --thu Meta_Round_010.thu
    python -m thunder_tpu_torch.cli.stackview select -i Meta_Round_010.thu -o sel.thu --classes 0 3 7
    python -m thunder_tpu_torch.cli.stackview view -i Reference_Round_010.mrcs \\
        --thu Meta_Round_010.thu --class-info Class_Info_Round_010.txt -o sel.thu

Unlike thunder_tpu's, the selector keeps its cursor on the page after
the terminal is resized (there, a key pressed after a resize could index
past the stack and raise IndexError).
"""

from __future__ import annotations

import argparse

import numpy as np


def _contact_sheet(stack: np.ndarray, cols: int = 8, pad: int = 2) -> np.ndarray:
    n, h, w = stack.shape
    rows = (n + cols - 1) // cols
    sheet = np.zeros((rows * (h + pad), cols * (w + pad)), np.float32)
    for i in range(n):
        img = stack[i]
        lo, hi = np.percentile(img, [1, 99])
        img = np.clip((img - lo) / max(hi - lo, 1e-12), 0, 1)
        r, c = divmod(i, cols)
        sheet[r * (h + pad):r * (h + pad) + h, c * (w + pad):c * (w + pad) + w] = img
    return sheet


def _png_bytes(img: np.ndarray) -> bytes:
    """A grayscale PNG of an image in [0, 1] (no pillow dependency)."""
    import struct
    import zlib

    data = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = data.shape
    raw = b"".join(b"\x00" + data[r].tobytes() for r in range(h))

    def chunk(tag, payload):
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(_png_bytes(img))


_RAMP = " .:-=+*#%@"
THUMB_W, THUMB_H = 22, 11


def _thumb_chars(img: np.ndarray, tw: int, th: int, contrast: float = 1.0):
    """Downsample one class average to a (th, tw) character thumbnail."""
    h, w = img.shape
    ys = (np.linspace(0, h - 1, th)).astype(int)
    xs = (np.linspace(0, w - 1, tw)).astype(int)
    t = img[np.ix_(ys, xs)]
    lo, hi = np.percentile(img, [2, 98])
    t = np.clip((t - lo) / max(hi - lo, 1e-12), 0, 1)
    t = np.clip(0.5 + (t - 0.5) * contrast, 0, 1)
    idx = (t * (len(_RAMP) - 1)).astype(int)
    return ["".join(_RAMP[i] for i in row) for row in idx]


def _keep_classes(thu_path: str, out_thu: str, classes) -> tuple:
    """Write the particles of ``classes`` to out_thu; (kept, total)."""
    from thunder_tpu_torch.io.thu import read_thu, write_thu

    t = read_thu(thu_path)
    keep = np.nonzero(np.isin(t.class_id, np.asarray(classes)))[0]
    write_thu(out_thu, t.select(keep))
    return len(keep), len(t)


class Selector:
    """The terminal selector's state and keys, apart from the screen:
    :meth:`fit` lays a page out for a terminal of (rows, cols) and keeps
    page and cursor on it, :meth:`key` applies one key."""

    def __init__(self, n: int, occ, res_a, out_thu, thu_path):
        self.n, self.occ, self.res_a = n, occ, res_a
        self.out_thu, self.thu_path = out_thu, thu_path
        self.order = np.arange(n)
        self.selected = np.zeros(n, bool)
        self.cursor = self.page = 0
        self.contrast = 1.0
        self.sort = "none"
        self.msg = ("space=select  s/S=sort occ/res  +/-=contrast  "
                    "w=write .thu  l=write list  q=quit")
        self.fit(24, 80)

    def fit(self, hh: int, ww: int) -> None:
        self.cols = max(1, ww // (THUMB_W + 2))
        rows = max(1, (hh - 2) // (THUMB_H + 2))
        self.per_page = self.cols * rows
        self.n_pages = (self.n + self.per_page - 1) // self.per_page
        self.page = min(self.page, self.n_pages - 1)
        self.start = self.page * self.per_page
        # a smaller terminal holds fewer thumbnails: the cursor stays on one
        self.cursor = min(self.cursor, self._last())

    def _last(self) -> int:
        return min(self.per_page, self.n - self.start) - 1

    def _resort(self, key: str, desc: bool):
        vals = self.occ if key == "occ" else self.res_a
        if vals is None:
            self.msg = f"no {key} data loaded"
            return self.order
        self.sort = key + ("-desc" if desc else "-asc")
        o = np.argsort(vals)
        return o[::-1] if desc else o

    def key(self, k: int) -> bool:
        """Apply key ``k``; False when it quits."""
        import curses

        if k == ord("q"):
            return False
        if k == ord(" "):
            ci = int(self.order[self.start + self.cursor])
            self.selected[ci] = not self.selected[ci]
        elif k == curses.KEY_RIGHT:
            self.cursor = min(self.cursor + 1, self._last())
        elif k == curses.KEY_LEFT:
            self.cursor = max(self.cursor - 1, 0)
        elif k == curses.KEY_DOWN:
            self.cursor = min(self.cursor + self.cols, self._last())
        elif k == curses.KEY_UP:
            self.cursor = max(self.cursor - self.cols, 0)
        elif k in (curses.KEY_NPAGE, curses.KEY_PPAGE):
            step = 1 if k == curses.KEY_NPAGE else -1
            self.page, self.cursor = min(max(self.page + step, 0), self.n_pages - 1), 0
            self.start = self.page * self.per_page
        elif k in (ord("+"), ord("=")):
            self.contrast = min(self.contrast * 1.3, 8.0)
        elif k == ord("-"):
            self.contrast = max(self.contrast / 1.3, 0.2)
        elif k == ord("s"):
            self.order = self._resort("occ", True)
        elif k == ord("S"):
            self.order = self._resort("res", False)
        elif k == ord("l"):
            lst = self.out_thu + ".classes.txt" if self.out_thu else "selected_classes.txt"
            with open(lst, "w") as f:
                f.write("\n".join(str(i) for i in np.nonzero(self.selected)[0]) + "\n")
            self.msg = f"wrote {lst}"
        elif k == ord("w"):
            if not (self.out_thu and self.thu_path):
                self.msg = "need -o and --thu to write particles"
            else:
                kept, total = _keep_classes(self.thu_path, self.out_thu,
                                            np.nonzero(self.selected)[0])
                self.msg = f"wrote {self.out_thu} ({kept}/{total} particles)"
        return True


def _curses_view(stack, occ, res_a, out_thu, thu_path):
    """Interactive class selector (MainWnd.h:55-92 operations)."""
    import curses

    sel = Selector(stack.shape[0], occ, res_a, out_thu, thu_path)

    def run(scr):
        curses.curs_set(0)
        while True:
            scr.erase()
            hh, ww = scr.getmaxyx()
            sel.fit(hh, ww)
            for slot, pos in enumerate(range(sel.start, min(sel.n, sel.start + sel.per_page))):
                ci = int(sel.order[pos])
                r, c = divmod(slot, sel.cols)
                y0, x0 = r * (THUMB_H + 2), c * (THUMB_W + 2)
                head = f"{'*' if sel.selected[ci] else ' '}{ci:3d}"
                if occ is not None:
                    head += f" {occ[ci]:.3f}"
                if res_a is not None and np.isfinite(res_a[ci]):
                    head += f" {res_a[ci]:.1f}A"
                attr = (curses.A_REVERSE if slot == sel.cursor else
                        (curses.A_BOLD if sel.selected[ci] else 0))
                try:
                    scr.addstr(y0, x0, head[:THUMB_W], attr)
                    for i, line in enumerate(_thumb_chars(stack[ci], THUMB_W, THUMB_H,
                                                          sel.contrast)):
                        scr.addstr(y0 + 1 + i, x0, line)
                except curses.error:
                    pass
            foot = (f"page {sel.page + 1}/{sel.n_pages}  "
                    f"sel {int(sel.selected.sum())}/{sel.n}  sort {sel.sort}  | {sel.msg}")
            try:
                scr.addstr(hh - 1, 0, foot[:ww - 1])
            except curses.error:
                pass
            scr.refresh()
            k = scr.getch()
            # a resize arrives as a key: lay the page out for the new size first
            sel.fit(*scr.getmaxyx())
            if not sel.key(k):
                return

    curses.wrapper(run)
    return sel.selected


def _read_stack(path: str) -> np.ndarray:
    from thunder_tpu_torch.io.mrc import read_mrc

    stack, _ = read_mrc(path, shift=False)
    return stack[None] if stack.ndim == 2 else stack


def _occupancy(thu_path: str, n: int) -> np.ndarray:
    from thunder_tpu_torch.io.thu import read_thu

    occ = np.bincount(read_thu(thu_path).class_id.astype(int), minlength=n).astype(float)
    return occ / max(occ.sum(), 1)


def main(argv=None):
    p = argparse.ArgumentParser(prog="thunder_stackview")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("show")
    s.add_argument("-i", required=True, help="class-average stack .mrcs")
    s.add_argument("-o", required=True, help="output PNG contact sheet")
    s.add_argument("--cols", type=int, default=8)
    s = sub.add_parser("info")
    s.add_argument("-i", required=True)
    s.add_argument("--thu", help="meta .thu for per-class occupancy")
    s = sub.add_parser("select")
    s.add_argument("-i", required=True, help="meta .thu")
    s.add_argument("-o", required=True, help="filtered .thu")
    s.add_argument("--classes", type=int, nargs="+", required=True)
    s = sub.add_parser("view")
    s.add_argument("-i", required=True, help="class-average stack .mrcs")
    s.add_argument("--thu", help="meta .thu (for 'w' save-particles)")
    s.add_argument("--class-info", help="Class_Info_Round_xxx.txt (occupancy/resolution)")
    s.add_argument("-o", help="output filtered .thu for 'w'")
    a = p.parse_args(argv)

    if a.cmd == "show":
        stack = _read_stack(a.i)
        _write_png(a.o, _contact_sheet(stack, a.cols))
        print(f"wrote {a.o} ({stack.shape[0]} classes)")
    elif a.cmd == "info":
        stack = _read_stack(a.i)
        occ = _occupancy(a.thu, stack.shape[0]) if a.thu else None
        for i in range(stack.shape[0]):
            line = f"class {i:3d}: std={stack[i].std():.4f}"
            if occ is not None:
                line += f" occupancy={occ[i]:.4f}"
            print(line)
    elif a.cmd == "view":
        import sys

        if not sys.stdout.isatty():
            sys.exit("view needs a terminal; use 'show'/'select' headless")
        stack = _read_stack(a.i)
        occ = res_a = None
        if a.class_info:
            rows = np.loadtxt(a.class_info, ndmin=2)
            occ = np.zeros(stack.shape[0])
            res_a = np.full(stack.shape[0], np.inf)
            for ci, o, r in rows[:, :3]:
                if 0 <= int(ci) < stack.shape[0]:
                    occ[int(ci)] = o
                    res_a[int(ci)] = r
        elif a.thu:
            occ = _occupancy(a.thu, stack.shape[0])
        sel = _curses_view(stack, occ, res_a, a.o, a.thu)
        print("selected classes:", " ".join(str(i) for i in np.nonzero(sel)[0]))
    else:
        kept, total = _keep_classes(a.i, a.o, a.classes)
        print(f"kept {kept}/{total} particles from classes {a.classes}")


if __name__ == "__main__":
    main()
