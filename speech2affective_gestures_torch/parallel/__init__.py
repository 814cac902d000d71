"""Data-parallel training over processes (`parallel.mesh`)."""
