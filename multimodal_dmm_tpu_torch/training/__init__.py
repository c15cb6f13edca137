"""Training runtime: the train step and its optimizer, the batch loader,
and evaluation."""
