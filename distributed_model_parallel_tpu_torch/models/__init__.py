"""Models of the port (so far: the serving subset of the Transformer LM)."""
