"""Launch layer: the LM serving command line and the meshes of ranks that
sharded HGNN execution runs over."""
