"""Name sets shared by the port's telemetry modules (`vocab.py`)."""
