"""Process identity (single process in this slice of the port)."""
