"""Fault plane: the env helpers the serve knobs read."""
