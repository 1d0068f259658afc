"""The decoder-only LM on the pooled serving cache."""
