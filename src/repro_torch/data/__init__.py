"""Data sources, batch plans and the data plane."""
