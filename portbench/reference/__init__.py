"""The frozen plain reference the benchmark's ``correct`` compares with:
NumPy only, nothing of the program."""
