"""The streaming weighted-sum kernels and their plain versions."""
