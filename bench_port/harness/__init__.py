"""The general machinery of the port's benchmark: the run, the seeded
weights, the traced slice and the training cells' shared steps."""
