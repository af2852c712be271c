"""The native library (`native/*.cpp`: WAV I/O, block streamer, batch
loader, WFST core) is built from source at first use with `make -C native`;
the build counts as set-up time."""

from __future__ import annotations

import fcntl
import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "libdsrnative.so"


def ensure_built() -> pathlib.Path:
    """Return the library's path, (re)building it first when its sources
    are newer.  A file lock serialises concurrent first uses (parallel test
    workers); a failed build raises with the compiler's output."""
    with open(NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", str(NATIVE_DIR)],
                               capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build {LIB_PATH}: {e}") from e
        if r.returncode:
            raise RuntimeError(
                f"building {LIB_PATH} failed:\n{r.stdout}{r.stderr}")
    return LIB_PATH
