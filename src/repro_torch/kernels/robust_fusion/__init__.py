"""The order-statistic kernels (top-k carve, trimmed mean, median) and
their plain versions."""
