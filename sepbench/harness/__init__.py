"""The benchmark's machinery: cells found by name, the traffic
generator, spans, the profiler's reduction, counts and the device
record."""
