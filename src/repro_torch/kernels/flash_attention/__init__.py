"""The flash-attention kernel (causal GQA prefill) and its plain version."""
