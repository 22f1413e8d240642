"""Serving on the port: the paged continuous-batching engine and the
in-process LLM server."""
