"""Runtime utilities: metrics, profiling, checkpointing."""
