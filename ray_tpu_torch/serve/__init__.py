"""Serving: the continuous-batching LLM engine over the paged KV cache."""
