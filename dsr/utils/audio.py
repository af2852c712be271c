"""Audio I/O + native sample streaming (ctypes binding to native/wavio.cpp).

The native library plays the reference's `SampleFeature` (libsndfile read,
channel select) and `BlockSizeConversion` roles (SURVEY.md §2.1 [K]): WAV
read/write and a threaded ring-buffer streamer that re-blocks a file into
fixed-size frames for chunked streaming pipelines.  Falls back to the
stdlib `wave` module if the shared library cannot be built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dsr.utils import nativelib

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(nativelib.ensure_built()))
    except (OSError, RuntimeError):
        return None
    lib.dsr_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.dsr_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
    ]
    lib.dsr_wav_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dsr_stream_open.restype = ctypes.c_void_p
    lib.dsr_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.dsr_stream_channels.argtypes = [ctypes.c_void_p]
    lib.dsr_stream_rate.argtypes = [ctypes.c_void_p]
    lib.dsr_stream_pop.restype = ctypes.c_longlong
    lib.dsr_stream_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
    ]
    lib.dsr_stream_close.argtypes = [ctypes.c_void_p]
    lib.dsr_loader_open.restype = ctypes.c_void_p
    lib.dsr_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.dsr_loader_next.restype = ctypes.c_int
    lib.dsr_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dsr_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """→ (samples (channels, frames) float32 in [-1, 1], sample_rate)."""
    lib = _load()
    if lib is not None:
        rate = ctypes.c_int()
        ch = ctypes.c_int()
        frames = ctypes.c_longlong()
        if lib.dsr_wav_info(path.encode(), ctypes.byref(rate), ctypes.byref(ch),
                            ctypes.byref(frames)) == 0:
            total = frames.value * ch.value
            buf = np.empty(total, np.float32)
            rc = lib.dsr_wav_read(path.encode(),
                                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), total)
            if rc == 0:
                return buf.reshape(frames.value, ch.value).T.copy(), rate.value
    # stdlib fallback (PCM16 only)
    import wave

    with wave.open(path, "rb") as w:
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        x = (data / 32768.0).astype(np.float32).reshape(-1, w.getnchannels()).T.copy()
        return x, w.getframerate()


def write_wav(path: str, samples: np.ndarray, sample_rate: int, pcm16: bool = True):
    """samples: (channels, frames) or (frames,) float32 in [-1, 1]."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    inter = np.ascontiguousarray(x.T.reshape(-1))
    lib = _load()
    if lib is not None:
        rc = lib.dsr_wav_write(
            path.encode(), inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.shape[1], x.shape[0], int(sample_rate), 1 if pcm16 else 0,
        )
        if rc == 0:
            return
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((np.clip(inter, -1, 1) * 32767).astype(np.int16).tobytes())


class SampleStream:
    """Native threaded streaming reader: pop fixed-size (channels, block)
    chunks from a WAV file (BlockSizeConversion + ring buffer)."""

    def __init__(self, path: str, block_frames: int, capacity_frames: int = 65536):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.dsr_stream_open(path.encode(), capacity_frames)
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.channels = lib.dsr_stream_channels(self._h)
        self.sample_rate = lib.dsr_stream_rate(self._h)
        self.block_frames = block_frames

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            raise StopIteration
        values = self.block_frames * self.channels
        buf = np.empty(values, np.float32)
        got = self._lib.dsr_stream_pop(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), values
        )
        if got == 0:
            self.close()
            raise StopIteration
        return buf.reshape(self.block_frames, self.channels).T.copy()

    def close(self):
        if self._h is not None:
            self._lib.dsr_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BlockSizeConverter:
    """Re-chunk a stream of sample blocks to a fixed output block size.

    Capability parity with the reference's `BlockSizeConversion` stage
    (`btk/feature/` [K], SURVEY.md §2.1): upstream produces blocks of one
    size (e.g. the native SampleStream's read granularity), downstream
    stages want another (e.g. the filterbank's D-sample hop).  Works on
    (..., S) blocks; leading axes (channels) must be constant.

    >>> conv = BlockSizeConverter(512)
    >>> for blk in stream:
    ...     for out in conv.push(blk): ...   # list of (..., 512) blocks
    >>> tail = conv.flush()                  # remainder, zero-padded
    """

    def __init__(self, out_size: int):
        if out_size <= 0:
            raise ValueError(f"out_size must be positive; got {out_size}")
        self.out_size = int(out_size)
        self._buf: np.ndarray | None = None

    def push(self, block: np.ndarray) -> list[np.ndarray]:
        """Eager re-chunk: returns the complete output blocks and retains
        the tail.  Output blocks (and the retained tail) are copies — the
        caller may reuse/overwrite its input buffer between pushes."""
        block = np.asarray(block)
        buf = block if self._buf is None else np.concatenate(
            [self._buf, block], axis=-1
        )
        n = buf.shape[-1] // self.out_size
        out = [
            buf[..., i * self.out_size : (i + 1) * self.out_size].copy()
            for i in range(n)
        ]
        self._buf = buf[..., n * self.out_size :].copy()
        return out

    def flush(self, pad: bool = True) -> np.ndarray | None:
        """Remaining samples as one final block (zero-padded if `pad`)."""
        buf, self._buf = self._buf, None
        if buf is None or buf.shape[-1] == 0:
            return None
        if pad and buf.shape[-1] < self.out_size:
            width = [(0, 0)] * (buf.ndim - 1) + [(0, self.out_size - buf.shape[-1])]
            buf = np.pad(buf, width)
        return buf


class BatchLoader:
    """Native batched corpus loader (native/loader.cpp): a C++ worker pool
    prefetches and decodes WAV files IN CORPUS ORDER while the accelerator
    computes; batches arrive zero-padded to a fixed row stride with
    per-utterance frame counts — the data-loader half of the native
    runtime (reference SampleFeature at corpus scale, SURVEY.md §2.1 [K]).

    Iterating yields (audio (B, channels, frames_max), lengths (B,)) with
    B ≤ batch on the last batch.  All files in a batch must share a channel
    count ≤ max_channels (standard corpus layout); mixed corpora should be
    bucketed first.

    Error recovery: an unreadable corpus file does NOT wedge the loader
    (native/loader.cpp consumes the failing slot and the next call
    continues) — the valid prefix of the batch is yielded, the bad path is
    recorded in `self.skipped` as (path, rc), and iteration resumes with
    the following file.
    """

    def __init__(self, paths: list[str], batch: int, max_frames: int,
                 max_channels: int = 1, workers: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.batch = batch
        self.max_channels = int(max_channels)
        self.max_values = int(max_frames) * int(max_channels)
        self.skipped: list[tuple[str, int]] = []
        self._paths = list(paths)
        self._consumed = 0         # corpus position (incl. skipped files)
        self._h = lib.dsr_loader_open(
            "\n".join(paths).encode(), batch, self.max_values, workers
        )
        if not self._h:
            raise IOError("dsr_loader_open failed (empty corpus or bad args)")

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._h is None:
                raise StopIteration
            out = np.empty((self.batch, self.max_values), np.float32)
            frames = np.empty(self.batch, np.int64)
            channels = np.empty(self.batch, np.int32)
            rates = np.empty(self.batch, np.int32)
            n = self._lib.dsr_loader_next(
                self._h,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frames.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                channels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
            if n < 0:
                # slots 0..pos-1 are valid, slot pos failed AND was consumed
                # (loader.cpp contract) — record it and yield the prefix.
                pos = -n - 1
                self.skipped.append(
                    (self._paths[self._consumed + pos], int(frames[pos]))
                )
                self._consumed += pos + 1
                n = pos
                if n == 0:
                    continue       # nothing valid this round; keep going
            elif n == 0:
                self.close()
                raise StopIteration
            else:
                self._consumed += n
            ch = int(channels[0])
            if not (channels[:n] == ch).all():
                raise ValueError(
                    "mixed channel counts in one batch "
                    f"({sorted(set(channels[:n].tolist()))}); bucket the "
                    "corpus by channel count first"
                )
            if ch > self.max_channels or self.max_values % ch != 0:
                raise ValueError(
                    f"batch channel count {ch} exceeds or does not divide "
                    f"max_channels={self.max_channels} "
                    f"(row stride {self.max_values})"
                )
            fmax = self.max_values // ch
            audio = out[:n].reshape(n, fmax, ch).transpose(0, 2, 1)
            self.rates = rates[:n].copy()
            return np.ascontiguousarray(audio), frames[:n].copy()

    def close(self):
        if self._h is not None:
            self._lib.dsr_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
