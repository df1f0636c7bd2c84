"""Systems under test: each module builds the program's entry point for a
configuration that names it under ``entry``."""
