"""Measurements of the device the port runs on (counterpart of the JAX
package's `bench/`)."""
