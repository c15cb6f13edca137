"""Applications."""
