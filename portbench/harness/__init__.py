"""The port's benchmark harness: set-up, the measured window, the traced
run, and the comparison with the plain reference."""
