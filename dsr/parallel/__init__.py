"""Parallelism layer: device meshes, sharding layouts, sharded pipelines.

The reference had NO intra-process parallelism or communication backend —
scale-out was per-utterance grid jobs with accumulator-file merges
(SURVEY.md §2.3 [K]).  Here parallelism is first-class: a
(data, model, subband) mesh; XLA collectives over the device interconnect are the
NCCL-equivalent; the decoder exchanges beam state with pmax/psum inside the
jitted scan (BASELINE.json "active-beam state exchanged via
collectives").
"""

from dsr.parallel.mesh import make_mesh  # noqa: F401
from dsr.parallel import sharding  # noqa: F401
