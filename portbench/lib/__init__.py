"""The harness: cells, the traffic generator, the trace, the yardstick."""
