"""Model schema, layers, attention and the forward for dense decoders."""
