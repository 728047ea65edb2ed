"""The port's benchmark (`README.md`)."""
