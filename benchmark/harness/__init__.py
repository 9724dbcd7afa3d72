"""The benchmark's own code: traffic, weights, counting, tracing, checks."""
