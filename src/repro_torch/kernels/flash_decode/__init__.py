"""The flash-decode kernel (one-token GQA attention over a ring KV
cache) and its plain version."""
