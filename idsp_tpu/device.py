"""Device discovery and set-up shared by the measurement scripts.

`bench.py`, `chip_smoke.py` and `benches/` call these so that every
number they print names the device it ran on, a run without a GPU fails
instead of measuring the CPU, and compiled programs are cached in one
fixed place.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

#: the repository root (the directory that holds the package)
REPO_ROOT = Path(__file__).resolve().parent.parent


def compile_cache_dir() -> str:
    """Where compiled programs are cached.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself);
    otherwise ``<repo>/.jax_cache``, a fixed path, so that a later run
    of the same checkout finds what an earlier one compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return env if env else str(REPO_ROOT / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


class CacheCounter:
    """Counts persistent compile-cache hits and misses, and backend
    compiles with their seconds, from JAX's monitoring events, from the
    moment it is created."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.compile_s = 0.0
        jax.monitoring.register_event_listener(self._on_event)
        jax.monitoring.register_event_duration_secs_listener(self._on_duration)

    def _on_event(self, event: str, **_kw) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def _on_duration(self, event: str, secs: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1
            self.compile_s += secs


def describe() -> dict:
    """The device as JAX reports it."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip() if out else ""


def require_gpu() -> dict:
    """`describe()` of a GPU; raises SystemExit on any other platform."""
    info = describe()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {info['platform']} ({info['kind']});"
            " this measurement needs the card"
        )
    return info
