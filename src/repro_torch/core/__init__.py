"""The aggregation service: workload classes, planner, store,
monitor, local engine, fusions and quantized transport."""
