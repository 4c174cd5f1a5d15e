"""Checkpoints in the JAX package's npz + manifest format, readable both ways."""
