"""Serving front ends of the port (the LLM request handler)."""
