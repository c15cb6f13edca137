"""Training runtime: the train step and its optimizer."""
