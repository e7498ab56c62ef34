"""Launch layer: the LM serving command line."""
