"""Algorithm 1: importance math and the train step."""
