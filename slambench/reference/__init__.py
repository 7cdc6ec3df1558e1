"""The plain reference the benchmark's check holds the port to. It imports
nothing of the port."""
