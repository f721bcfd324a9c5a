"""Fused compacted path: Morton keys and the shared corner geometry (plain versions)."""
