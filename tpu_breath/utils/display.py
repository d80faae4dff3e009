"""Console status lines and a progress counter — the LX layer of the
reference (src/utils/display.py:6-36), in plain print."""
from __future__ import annotations

import sys
import time


def print_start(msg):
    print(f"▶ {msg}", flush=True)


def print_success(msg):
    print(f"✔ {msg}", flush=True)


def print_warning(msg):
    print(f"⚠ {msg}", flush=True)


def print_error(msg):
    print(f"✘ {msg}", flush=True)


def print_info(msg):
    print(f"· {msg}", flush=True)


def progress_bar(iterable, description: str, total: int | None = None):
    """tqdm-style iterator wrapper (reference src/utils/display.py:17-18),
    implemented without tqdm: a line-rewriting counter with rate + ETA,
    silent when stdout is not a TTY (keeps logs clean)."""
    if total is None:
        try:
            total = len(iterable)
        except TypeError:
            total = 0
    tty = sys.stdout.isatty()
    t0 = time.time()
    last = 0.0
    for i, item in enumerate(iterable, 1):
        yield item
        now = time.time()
        if tty and (now - last > 0.1 or i == total):
            last = now
            rate = i / max(now - t0, 1e-9)
            eta = (total - i) / rate if total and rate > 0 else 0.0
            frac = i / total if total else 0.0
            width = 24
            fill = int(width * frac)
            bar = "#" * fill + "-" * (width - fill)
            sys.stdout.write(
                f"\r{description} [{bar}] {i}/{total or '?'} "
                f"{rate:,.1f}/s eta {eta:,.0f}s")
            sys.stdout.flush()
    if tty:
        sys.stdout.write("\n")
        sys.stdout.flush()
