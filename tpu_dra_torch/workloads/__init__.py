"""Serving payload of the port: Llama, the paged KV cache, the engine."""
