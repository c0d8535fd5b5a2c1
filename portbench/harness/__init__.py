"""The benchmark's harness: drivers, traffic, traces and costs."""
