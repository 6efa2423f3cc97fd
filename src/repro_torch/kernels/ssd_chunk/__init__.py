"""The SSD (Mamba2) chunked-scan kernel and its plain version."""
