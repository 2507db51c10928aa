"""Model configurations of the paper's experiments."""
