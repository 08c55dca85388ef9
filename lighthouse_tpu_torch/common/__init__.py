"""Host-side services of the port: metrics and tracing."""
