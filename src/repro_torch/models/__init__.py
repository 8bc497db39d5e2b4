"""The LM substrate's models, ported so far: the dense decoder-only
transformer, for serving (prefill and decode)."""
