"""Host-side services of the port: metrics, tracing, logging, the flight
recorder and the slot ledger."""
