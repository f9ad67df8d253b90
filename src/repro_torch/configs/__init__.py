"""Model configurations the port runs: the dense LLMs of the paper."""
