"""Model code: the dense GQA transformer LM."""
