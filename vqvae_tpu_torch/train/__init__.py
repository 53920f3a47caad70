"""Training: state, step, loop, metrics and weights-only export."""
