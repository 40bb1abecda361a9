"""Host-side utilities: checksums, metrics, tracing."""
