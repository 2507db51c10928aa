"""The benchmark's harness: cell resolution, the closed loop, the trace
reduction, the frozen roofline count and the output check."""
