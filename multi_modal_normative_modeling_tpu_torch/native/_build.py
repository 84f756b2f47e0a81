"""Shared build-and-load plumbing for the native C++ libraries.

Compiles the source with g++ on first use into ``native/_build/`` beside
this file (ignored by git), keyed by a source hash, and dlopens it. Used by
fastcsv.py and fastwrite.py so compiler flags, the build layout and the
concurrent-build discipline can never drift between them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).with_name("_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def load_native(src: Path, stem: str, configure) -> ctypes.CDLL:
    """Build (if needed) and load ``src`` as lib<stem>_<hash>.so, then run
    ``configure(lib)`` to declare the ctypes signatures. Raises on any
    failure — callers latch that into their pandas fallback."""
    source = src.read_bytes()
    tag = hashlib.sha256(source).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # pid-unique tmp: two processes cold-building concurrently must not
        # publish each other's partially written library via os.replace
        tmp = out.with_suffix(f".building.{os.getpid()}.so")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    configure(lib)
    return lib
