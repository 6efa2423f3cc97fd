"""Layers of the model stack: plain functions over tensors and the
modules that hold their parameters."""
