"""Interactive app shell: a live, in-terminal render loop.

The port of the JAX package's ``interactive.py`` onto this package's
``Renderer`` (its own copy; it imports nothing of the JAX package).  The
reference's app shell is a GLFW window with an orbit camera and ImGui stats
(``src/main.cpp:70-133`` run loop, ``:376-433`` cursor orbit + accumulation
reset, ``:357-369`` S = save / ESC = save + exit).  Headless, the shell
renders straight to the terminal: the accumulating film is drawn as 24-bit
ANSI half-block cells (two image rows per text row), the camera orbits from
the keyboard, and the status line carries the same per-frame telemetry the
reference shows in ImGui (iteration, ms/frame, FPS, Mrays/s).

Keys (reference bindings where they exist):
  arrows / h j k l   orbit phi/theta (accumulation resets, main.cpp:423-425)
  + / -              dolly zoom
  s                  save the current accumulation as PNG (main.cpp:361-364)
  space              pause / resume tracing
  q or ESC           save and exit (main.cpp:357-360)

The frame rasterizer (`frame_to_ansi`) and key dispatch (`handle_key`) are
pure and unit-tested; only `run` touches the TTY.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

ORBIT_STEP = 0.1  # radians per keypress (reference: drag-scaled)
ZOOM_STEP = 0.25


def frame_to_ansi(
    img: np.ndarray, cols: int, rows: int, mirror: bool = True
) -> str:
    """Render an [H, W, 3] float image (accumulation / iterations) as ANSI
    truecolor half-block art: each text cell shows two vertically stacked
    pixels (fg = upper, bg = lower).  Uses the same clamp + x-mirror as the
    PNG writer so the terminal view matches the saved file."""
    h, w = img.shape[:2]
    if mirror:
        img = img[:, ::-1]
    # nearest-neighbor downsample to (2*rows, cols)
    ys = np.clip((np.arange(2 * rows) + 0.5) * h / (2 * rows), 0, h - 1)
    xs = np.clip((np.arange(cols) + 0.5) * w / cols, 0, w - 1)
    small = img[ys.astype(int)][:, xs.astype(int)]
    u8 = (np.clip(small, 0.0, 1.0) * 255.0).astype(np.uint8)
    top, bot = u8[0::2], u8[1::2]
    lines = []
    for r in range(rows):
        cells = []
        for c in range(cols):
            tr, tg, tb = (int(x) for x in top[r, c])
            br, bg_, bb = (int(x) for x in bot[r, c])
            cells.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class InteractiveShell:
    """Drives a Renderer from keyboard input; display is injected so the
    loop is testable without a TTY."""

    def __init__(self, renderer, out_dir: str = "img"):
        self.r = renderer
        self.out_dir = out_dir
        self.paused = False
        self.quit = False
        self.message = ""
        self.loop_ms = 0.0  # wall-clock per displayed frame (step + fetch)
        self._rays_per_frame = float(renderer.static.pixel_count)
        self._frame_no = 0

    # -- key dispatch (pure; returns True when the key was consumed) -------
    def handle_key(self, key: str) -> bool:
        r = self.r
        if key in ("q", "\x1b"):  # ESC saves and exits (main.cpp:357-360)
            self.message = f"saved {r.save(out_dir=self.out_dir)}"
            self.quit = True
        elif key == "s":  # save (main.cpp:361-364)
            self.message = f"saved {r.save(out_dir=self.out_dir)}"
        elif key == " ":
            self.paused = not self.paused
            self.message = "paused" if self.paused else "tracing"
        elif key in ("h", "D"):  # D/C/A/B: arrow-key escape finals
            r.orbit_camera(dphi=-ORBIT_STEP)
        elif key in ("l", "C"):
            r.orbit_camera(dphi=ORBIT_STEP)
        elif key in ("k", "A"):
            r.orbit_camera(dtheta=ORBIT_STEP)
        elif key in ("j", "B"):
            r.orbit_camera(dtheta=-ORBIT_STEP)
        elif key == "+":
            r.orbit_camera(dzoom=-ZOOM_STEP)
        elif key == "-":
            r.orbit_camera(dzoom=ZOOM_STEP)
        else:
            return False
        return True

    def status_line(self) -> str:
        """ImGui-equivalent telemetry.  Frame time is the LOOP wall time
        (dispatch + preview fetch): the loop's pipelined ``step_many(...,
        sync=False)`` records no frame times in the renderer's ``stats``,
        which hold only synced steps'."""
        r = self.r
        # The per-depth alive fetch is a host read of its own; refresh the
        # Mrays/s denominator every 16th frame only.
        if self._frame_no % 16 == 1 and getattr(r, "_alive_counts", None) is not None:
            self._rays_per_frame = float(
                r._alive_counts.sum() + r.static.pixel_count
            )
        ms = self.loop_ms if self.loop_ms > 0 else r.stats.mean_ms
        fps = 1e3 / ms if ms > 0 else 0.0
        mrays = self._rays_per_frame / (ms * 1e3) if ms > 0 else 0.0
        return (
            f" iter {r.iteration}  {ms:6.2f} ms/frame  "
            f"{fps:5.1f} FPS  {mrays:6.1f} Mrays/s"
            f"  [{'paused' if self.paused else 'tracing'}] {self.message}"
        )

    # -- the live loop ------------------------------------------------------
    def run(self, spp_per_frame: int = 1, max_iters: int = 0) -> int:
        if not sys.stdin.isatty():
            print(
                "interactive mode needs a TTY (try without --interactive)",
                file=sys.stderr,
            )
            return 1
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        cols, rows = self._term_size()
        out = sys.stdout
        try:
            tty.setcbreak(fd)
            out.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
            while not self.quit:
                while select.select([fd], [], [], 0)[0]:
                    ch = os.read(fd, 1).decode(errors="ignore")
                    if ch == "\x1b":  # arrow keys: ESC [ A..D
                        seq = ""
                        while select.select([fd], [], [], 0.01)[0]:
                            seq += os.read(fd, 1).decode(errors="ignore")
                        ch = seq[-1] if seq else "\x1b"
                    self.handle_key(ch)
                t0 = time.perf_counter()
                if not self.paused:
                    # Pipelined dispatch: the preview fetch below is the
                    # sync point, so the device computes the next iteration
                    # while the host rasterizes this one.
                    self.r.step_many(spp_per_frame, sync=False)
                # Device-side downsample to the terminal grid: fetches
                # the terminal's cells instead of the full film.
                img = self.r.preview_image(2 * (rows - 1), cols)
                self._frame_no += 1
                self.loop_ms = (time.perf_counter() - t0) * 1e3
                out.write("\x1b[H")
                out.write(frame_to_ansi(img, cols, rows - 1))
                out.write("\n\x1b[K" + self.status_line()[: cols - 1])
                out.flush()
                if self.paused:
                    time.sleep(0.05)
                if max_iters and self.r.iteration >= max_iters:
                    self.handle_key("q")
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            out.write("\x1b[?25h\x1b[0m\n")
            out.flush()
        if self.message:
            print(self.message)
        return 0

    @staticmethod
    def _term_size():
        try:
            sz = os.get_terminal_size()
            return max(20, min(sz.columns, 160)), max(10, min(sz.lines, 90))
        except OSError:
            return 80, 40
