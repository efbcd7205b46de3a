"""Training data: the seeded synthetic token stream."""
