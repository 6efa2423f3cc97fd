"""Device, hardware, pytree and build-cache helpers."""
