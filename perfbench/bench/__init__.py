"""The harness: the benchmark's spec, the traffic generator, the closed
loop, the profiler's reading and the run of one cell."""
