"""The benchmark's harness: cells found by name, the drivers of the traffic
kinds, the trace reader, and the yardstick (peaks and FLOP counts)."""
