"""Model configuration, parameter tables and the dense transformer family."""
