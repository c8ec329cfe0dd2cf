"""The plain reference: NumPy (and torch for the lower-precision
control), independent of the port."""
