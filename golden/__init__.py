"""Golden (NumPy/SciPy) reference implementations for the DSR framework.

Every algorithm in `dsr` is validated `allclose` against this package
(SURVEY.md §4: "Golden model first").  Code here is written for clarity and
numerical fidelity to the mathematical definitions, NOT for speed, and it is
the single source of truth for conventions (window orientation, FFT sign,
overlap-add alignment, semiring definitions).

No JAX imports are allowed in this package.
"""
