"""dsr — a distant speech recognition framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of the
`distantspeechrecognition` toolkit family (BTK beamforming + Millennium ASR;
see SURVEY.md): oversampled subband DFT filterbanks, adaptive beamforming
(DS / superdirective MVDR / GSC), post-filtering, source localisation and
speaker tracking, MFCC / LPC / warped-MVDR front ends, GMM-HMM acoustic
models, WFST graph construction and batched token-passing Viterbi decoding,
ML/MMI training and speaker adaptation — plus a Conformer-CTC stretch model.

Design stance (SURVEY.md §7): frames are batch dimensions, streams are
scanned pure functions, subbands are a mesh axis, and the decoder is a
batched `lax.scan` — nothing retains the reference's pull-model object graph
or SWIG layering; only capabilities and numerics carry over.
"""

__version__ = "0.1.0"

import os as _os
import pathlib as _pathlib

import jax as _jax

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at one fixed path inside the
# checkout (the path is part of the cache key, so it must not move).
# Opt out: DSR_NO_CACHE=1.
if not _os.environ.get("DSR_NO_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update(
            "jax_compilation_cache_dir",
            str(_pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
