"""Fused compacted path: for now only the Morton key the compact stage sorts by."""
