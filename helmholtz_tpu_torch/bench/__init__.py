"""Measurements of the device the port runs on, and of the solver's parts
against it (counterpart of the JAX package's `bench/`)."""
