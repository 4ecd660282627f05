"""K4: the survival-gated CE + importance-score chunk."""
