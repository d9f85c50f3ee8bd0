"""Checkpoints, metrics logging and profiling hooks."""
