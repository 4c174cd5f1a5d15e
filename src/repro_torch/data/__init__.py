"""The synthetic token stream and calibration batches (numpy on the host)."""
