"""Update-size configurations (the paper's Table I)."""
