"""The plain reference of the benchmark's cells: NumPy, written from the
semantics each configuration states. It imports nothing of the program
and nothing of JAX; the HyperLogLog arithmetic is a frozen copy."""
