"""Registered architecture configurations (one module per arch id)."""
