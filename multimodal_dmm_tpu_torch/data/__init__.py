"""Sequence data on the host (numpy): collation and deletion operators."""
