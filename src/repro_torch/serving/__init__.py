"""Serving engine (handler mode), its KV page pool and its steps."""
