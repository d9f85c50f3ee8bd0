"""The plain reference of the benchmark: NumPy only, no part of the program."""
