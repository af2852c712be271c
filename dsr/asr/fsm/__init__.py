"""WFST algebra and decoding-graph construction (build-time, CPU).

Capability parity target: reference `asr/fsm/` — WFSAcceptor/WFSTransducer
with composition, determinization, minimization, ε-removal and weight
pushing over the tropical/log semirings, plus H/C/L/G builders and the
composed HCLG (SURVEY.md §2.2 [K]).  Graph construction runs un-jitted on
the host (exactly as the reference's did); the run-time artifact is a packed
int32/float32 arc table consumed by the batched decoder
(dsr/asr/decoder/wfst_decoder.py).
"""

from dsr.asr.fsm.wfst import Wfst, EPS  # noqa: F401
