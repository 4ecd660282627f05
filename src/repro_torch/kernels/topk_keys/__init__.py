"""K6: the sharded selection's exponential-race keys."""
