"""Planning, packing, metrics and memory helpers."""
