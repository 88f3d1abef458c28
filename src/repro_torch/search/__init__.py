"""Decision helpers on scored grids (the part the serving slice uses)."""
