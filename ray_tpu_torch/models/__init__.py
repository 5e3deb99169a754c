"""Models of the port (the GPT family, inference half)."""
