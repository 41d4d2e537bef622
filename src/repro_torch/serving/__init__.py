"""Serving runtime of the port: paged KV manager, engine, frontend."""
