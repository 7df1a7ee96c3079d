"""The plain reference of every cell: plain PyTorch and NumPy, written from
the published semantics. It imports nothing of the program and takes
nothing the program made: it rebuilds the weights, the corpus and the
queries from the run's seed, and reads the program's outputs only to judge
them."""
