"""Part of the plain reference (see the package docstring)."""
