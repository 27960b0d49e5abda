"""The benchmark's harness: manifest, weights, traffic, the system under
test, the measured window, the trace and the check."""
