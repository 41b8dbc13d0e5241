"""The port's benchmark harness: set-up, windows, metrics and the check."""
