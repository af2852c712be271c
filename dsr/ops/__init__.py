"""DSP / feature / model ops (JAX/XLA)."""
