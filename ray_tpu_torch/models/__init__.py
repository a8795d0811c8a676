"""Models: the llama-style transformer, KV-cache generation and paged serving."""
